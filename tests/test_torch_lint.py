"""The port's invariant lint engine (container_engine_accelerators_tpu_
torch/analysis/lint.py) and its CLI (``cmd/agent_lint.py``), mirroring
the JAX package's tests/test_lint.py.

Every JAX case runs against the port's engine: a seeded violation of
each rule is detected on a synthetic snippet, the idiomatic fixed form
is not, inline suppressions must name their rule, and the CLI (``python
-m container_engine_accelerators_tpu_torch.cmd.agent_lint``) keeps the
exit codes the gate depends on (0 clean, 1 findings, 2 internal error)
— the port at HEAD lints clean.  Then the two engines side by side: the
same seeded snippets give the same findings.
"""

import json
import os
import random
import subprocess
import sys
import textwrap

import pytest

from container_engine_accelerators_tpu.analysis import lint as jax_lint
from container_engine_accelerators_tpu_torch.analysis import lint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AGENT_LINT = "container_engine_accelerators_tpu_torch.cmd.agent_lint"


def run_lint(tmp_path, source, *, filename="snippet.py", readme="",
             rules=None, clock=False, netio=False):
    """Lint one synthetic snippet in an isolated root; returns the
    finding list.  ``clock``/``netio`` mark the snippet as carrying
    that module contract."""
    path = tmp_path / filename
    path.write_text(textwrap.dedent(source))
    readme_path = tmp_path / "README.md"
    readme_path.write_text(readme)
    cfg = lint.Config(
        roots=[str(tmp_path)],
        repo_root=str(tmp_path),
        readme=str(readme_path),
        clock_modules=(filename,) if clock else (),
        netio_modules=(filename,) if netio else (),
        metrics_source="",
    )
    findings, errors = lint.lint(cfg, rules)
    assert errors == [], errors
    return findings


def rules_of(findings):
    return {f.rule for f in findings}


class TestRawSocketSend:
    def test_seeded_raw_sendall_is_detected(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def tx(sock, frame):
                sock.sendall(frame)
            """)
        assert rules_of(findings) == {"raw-socket-send"}
        assert findings[0].line == 2

    def test_netio_helper_call_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.utils import netio

            def tx(sock, frame):
                netio.sendall(sock, frame)
            """)
        assert findings == []

    def test_the_netio_module_itself_is_exempt(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def sendall(sock, data):
                sock.sendall(data)
            """, netio=True)
        assert findings == []


class TestNaiveClock:
    def test_wall_clock_in_clock_module_is_detected(self, tmp_path):
        findings = run_lint(tmp_path, """\
            import time
            import datetime

            def now():
                return time.time()

            def today():
                return datetime.datetime.now()
            """, clock=True)
        assert rules_of(findings) == {"naive-clock"}
        assert len(findings) == 2

    def test_injected_clock_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            import time

            def wait(deadline, now=time.monotonic):
                return now() < deadline
            """, clock=True)
        assert findings == []

    def test_wall_clock_outside_clock_modules_is_fine(self, tmp_path):
        findings = run_lint(tmp_path, """\
            import time

            def stamp():
                return time.time()
            """)
        assert findings == []


class TestBareExcept:
    def test_seeded_bare_except_is_detected(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def poll():
                try:
                    work()
                except:
                    pass
            """)
        assert "bare-except" in rules_of(findings)

    def test_typed_except_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def poll():
                try:
                    work()
                except OSError:
                    log()
            """)
        assert findings == []


class TestSwallowedException:
    def test_seeded_broad_pass_is_detected(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def body():
                try:
                    work()
                except Exception:
                    pass
            """)
        assert "swallowed-exception" in rules_of(findings)

    def test_broad_catch_that_logs_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def body(log):
                try:
                    work()
                except Exception as e:
                    log(e)
            """)
        assert findings == []

    def test_narrow_pass_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def body():
                try:
                    work()
                except FileNotFoundError:
                    pass
            """)
        assert findings == []


class TestThreadDaemon:
    def test_seeded_undecided_thread_is_detected(self, tmp_path):
        findings = run_lint(tmp_path, """\
            import threading

            def spawn(fn):
                t = threading.Thread(target=fn)
                t.start()
                return t
            """)
        assert rules_of(findings) == {"thread-daemon"}

    def test_explicit_daemon_decision_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            import threading

            def spawn(fn):
                t = threading.Thread(target=fn, daemon=False)
                t.start()
                t.join()
                return t
            """)
        assert findings == []


class TestUnjoinedThread:
    def test_seeded_fire_and_forget_is_detected(self, tmp_path):
        findings = run_lint(tmp_path, """\
            import threading

            def spawn(fn):
                threading.Thread(target=fn, daemon=False).start()
            """)
        assert "unjoined-thread" in rules_of(findings)

    def test_daemon_fire_and_forget_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            import threading

            def spawn(fn):
                threading.Thread(target=fn, daemon=True).start()
            """)
        assert findings == []


class TestUndocumentedMetric:
    def test_seeded_undocumented_counter_is_detected(self, tmp_path):
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.metrics import counters

            def hit():
                counters.inc("demo.hits")
            """, readme="# metrics\n\n`demo.other`\n")
        assert rules_of(findings) == {"undocumented-metric"}
        assert "demo.hits" in findings[0].message

    def test_documented_counter_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.metrics import counters

            def hit():
                counters.inc("demo.hits")
            """, readme="# metrics\n\n`demo.hits` — demo counter\n")
        assert findings == []

    def test_fstring_placeholder_matches_readme_wildcard(self, tmp_path):
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.metrics import counters

            def hit(site):
                counters.inc(f"demo.fired.{site}")
            """, readme="# metrics\n\n`demo.fired.<site>` — per site\n")
        assert findings == []

    def test_suppressed_site_does_not_hide_other_sites(self, tmp_path):
        """Suppressions are line-scoped: disabling one sighting of an
        undocumented name must not swallow a different call site of
        the same name (no name-level dedup before suppression)."""
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.metrics import counters

            def demo():
                counters.inc("demo.hits")  # lint: disable=undocumented-metric

            def prod():
                counters.inc("demo.hits")
            """, readme="")
        assert [f.line for f in findings] == [7]

    def test_dynamic_names_are_not_literals(self, tmp_path):
        """A variable passed to counters.inc is not a name literal —
        the rule only holds literal/f-string names to the bar."""
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.metrics import counters

            def hit(name):
                counters.inc(name)
            """, readme="")
        assert findings == []


class TestUndocumentedSpan:
    def test_seeded_undocumented_span_is_detected(self, tmp_path):
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.obs import trace

            def work():
                with trace.span("demo.phase"):
                    pass
                trace.event("demo.marker")
                trace.record_span("demo.recorded", duration_s=1.0)
            """, readme="# spans\n\n`demo.other`\n")
        assert rules_of(findings) == {"undocumented-span"}
        assert {f.message.split("'")[1] for f in findings} == \
            {"demo.phase", "demo.marker", "demo.recorded"}

    def test_documented_span_is_clean(self, tmp_path):
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.obs import trace

            def work():
                with trace.span("demo.phase"):
                    pass
            """, readme="# spans\n\n`demo.phase` — a demo phase\n")
        assert findings == []

    def test_fstring_placeholder_matches_readme_wildcard(self, tmp_path):
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.obs import trace

            def work(role):
                trace.event(f"demo.worker.{role}")
            """, readme="# spans\n\n`demo.worker.<role>` — per role\n")
        assert findings == []

    def test_dynamic_names_are_not_literals(self, tmp_path):
        findings = run_lint(tmp_path, """\
            from container_engine_accelerators_tpu_torch.obs import trace

            def work(name):
                with trace.span(name):
                    pass
            """, readme="")
        assert findings == []


class TestSuppressions:
    def test_inline_suppression_naming_the_rule_wins(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def tx(sock, frame):
                sock.sendall(frame)  # lint: disable=raw-socket-send
            """)
        assert findings == []

    def test_suppression_naming_a_different_rule_does_not(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def tx(sock, frame):
                sock.sendall(frame)  # lint: disable=bare-except
            """)
        assert rules_of(findings) == {"raw-socket-send"}

    def test_suppression_only_covers_its_line(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def tx(sock, frame):
                sock.sendall(frame)  # lint: disable=raw-socket-send
                sock.sendall(frame)
            """)
        assert [f.line for f in findings] == [3]


class TestEngine:
    def test_all_registry_rules_have_seeded_detection(self, tmp_path):
        """One snippet seeding a violation of every per-file rule at
        once: each registered rule must convict — an engine or
        registry regression that silently drops a rule fails here."""
        findings = run_lint(tmp_path, """\
            import threading
            from container_engine_accelerators_tpu_torch.metrics import counters
            from container_engine_accelerators_tpu_torch.obs import trace

            def body(sock, frame):
                counters.inc("never.documented")
                trace.event("never.documented.span")
                sock.sendall(frame)
                threading.Thread(target=body).start()
                try:
                    pass
                except:
                    pass
                try:
                    pass
                except Exception:
                    pass
            """, readme="")
        expected = {"raw-socket-send", "bare-except",
                    "swallowed-exception", "thread-daemon",
                    "unjoined-thread", "undocumented-metric",
                    "undocumented-span"}
        assert expected <= rules_of(findings)
        # (naive-clock needs the clock-module contract; its seeded
        # positive case is TestNaiveClock.)
        assert len(expected) + 1 == len(lint.RULES), (
            "a new rule joined the registry without a seeded "
            "positive case — add one here or in its own class"
        )

    def test_rule_filter_runs_only_named_rules(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def tx(sock, frame):
                try:
                    sock.sendall(frame)
                except:
                    pass
            """, rules=["bare-except"])
        assert rules_of(findings) == {"bare-except"}

    def test_syntax_error_is_an_internal_error(self, tmp_path):
        (tmp_path / "broken.py").write_text("def f(:\n")
        cfg = lint.Config(roots=[str(tmp_path)],
                          repo_root=str(tmp_path),
                          readme=str(tmp_path / "README.md"),
                          metrics_source="")
        findings, errors = lint.lint(cfg)
        assert len(errors) == 1 and "broken.py" in errors[0]

    def test_findings_sorted_and_rendered_with_location(self, tmp_path):
        findings = run_lint(tmp_path, """\
            def tx(sock, frame):
                sock.sendall(frame)
                sock.sendall(frame)
            """)
        assert [f.line for f in findings] == [2, 3]
        rendered = str(findings[0])
        assert rendered.startswith("snippet.py:2: [raw-socket-send]")


class TestAgentLintCli:
    def _run(self, *args, cwd=REPO):
        env = dict(os.environ, PYTHONPATH=REPO)
        return subprocess.run(
            [sys.executable, "-m", AGENT_LINT, *args],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=120,
        )

    def test_repo_at_head_is_clean_exit_0(self):
        """The acceptance bar itself: this CLI at its default roots (the
        port's package) exits 0 at HEAD."""
        proc = self._run()
        assert proc.returncode == 0, proc.stdout + proc.stderr

    def test_findings_exit_1_with_locations(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text("def tx(sock, b):\n    sock.sendall(b)\n")
        proc = self._run(str(bad))
        assert proc.returncode == 1
        assert "bad.py:2: [raw-socket-send]" in proc.stdout

    def test_json_output_is_machine_readable(self, tmp_path):
        bad = tmp_path / "bad.py"
        bad.write_text("def tx(sock, b):\n    sock.sendall(b)\n")
        proc = self._run("--json", str(bad))
        assert proc.returncode == 1
        blob = json.loads(proc.stdout)
        assert blob["findings"][0]["rule"] == "raw-socket-send"
        assert blob["elapsed_s"] < 30  # the lint budget, measured

    def test_cwd_relative_path_is_linted_not_silently_empty(self,
                                                            tmp_path):
        """A path relative to the invoking CWD must be linted from
        there — not resolved against the repo root into nothing and
        reported clean."""
        bad = tmp_path / "bad.py"
        bad.write_text("def tx(sock, b):\n    sock.sendall(b)\n")
        proc = self._run("bad.py", cwd=str(tmp_path))
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "raw-socket-send" in proc.stdout

    def test_missing_path_is_internal_error_exit_2(self, tmp_path):
        proc = self._run(str(tmp_path / "nope"))
        assert proc.returncode == 2
        assert "internal error" in proc.stderr

    def test_syntax_error_is_internal_error_exit_2(self, tmp_path):
        bad = tmp_path / "broken.py"
        bad.write_text("def f(:\n")
        proc = self._run(str(bad))
        assert proc.returncode == 2

    def test_unknown_rule_is_internal_error_exit_2(self):
        proc = self._run("--rules", "no-such-rule")
        assert proc.returncode == 2
        assert "unknown rule" in proc.stderr

    def test_list_rules_prints_the_registry(self):
        proc = self._run("--list-rules")
        assert proc.returncode == 0
        for name in lint.RULES:
            assert name in proc.stdout


# ---------------------------------------------------------------------------
# The port's defaults, and parity with the JAX package's engine
# ---------------------------------------------------------------------------


def test_defaults_name_the_ports_modules():
    cfg = lint.Config()
    assert cfg.roots == [os.path.join(REPO,
                                      "container_engine_accelerators_tpu_"
                                      "torch")]
    assert cfg.readme == os.path.join(REPO, "README.md")
    assert cfg.metrics_source == os.path.join(REPO, lint.METRICS_SOURCE)
    for rel in lint.CLOCK_MODULES + lint.NETIO_MODULES + (
            lint.METRICS_SOURCE,):
        assert rel.startswith("container_engine_accelerators_tpu_torch/")
        assert os.path.exists(os.path.join(REPO, rel)), rel
    assert sorted(lint.RULES) == sorted(jax_lint.RULES)


# Fragments a seeded snippet is drawn from: each rule's violation and its
# fixed form, and suppressions named right and wrong.
FRAGMENTS = (
    "sock.sendall(frame)",
    "netio.sendall(sock, frame)",
    "sock.sendall(frame)  # lint: disable=raw-socket-send",
    "sock.sendall(frame)  # lint: disable=bare-except",
    "t0 = time.time()",
    "t0 = time.monotonic()",
    "threading.Thread(target=body).start()",
    "threading.Thread(target=body, daemon=True).start()",
    "th = threading.Thread(target=body, daemon=False)",
    "counters.inc('never.documented')",
    "counters.inc('documented.name')",
    "counters.inc(f'fault.fired.{site}')",
    "timeseries.gauge('goodput.link.n0->n1', 1)",
    "histo.observe('documented.hist', 1.0)",
    "trace.event('never.documented.span')",
    "trace.span('documented.span')",
    "try:\n        pass\n    except:\n        pass",
    "try:\n        pass\n    except Exception:\n        pass",
    "try:\n        pass\n    except Exception:\n        continue",
    "try:\n        pass\n    except OSError:\n        pass",
)
README = ("| `documented.name` | `fault.fired.<site>` | `documented.hist` |\n"
          "| `documented.span` |\n")


def _snippet(seed):
    rng = random.Random(seed)
    body = "\n".join("    " + rng.choice(FRAGMENTS)
                     for _ in range(rng.randint(1, 12)))
    return ("import threading\nimport time\n"
            "from m import counters, histo, netio, timeseries, trace\n\n\n"
            f"def body(sock, frame, site):\n{body}\n")


def _findings(mod, tmp_path, clock):
    cfg = mod.Config(roots=[str(tmp_path)], repo_root=str(tmp_path),
                     readme=str(tmp_path / "README.md"),
                     clock_modules=("snippet.py",) if clock else (),
                     metrics_source="")
    findings, errors = mod.lint(cfg)
    assert errors == []
    return [(f.rule, f.path, f.line, f.message) for f in findings]


@pytest.mark.parametrize("clock", [False, True], ids=["plain", "clock"])
@pytest.mark.parametrize("seed", range(12))
def test_engines_give_the_same_findings_on_seeded_snippets(tmp_path, seed,
                                                           clock):
    """Tolerance: none — the same findings, in order, message for
    message."""
    (tmp_path / "snippet.py").write_text(_snippet(seed))
    (tmp_path / "README.md").write_text(README)
    ours = _findings(lint, tmp_path, clock)
    assert ours == _findings(jax_lint, tmp_path, clock)


def test_engines_agree_over_the_port():
    """The JAX engine, given the port's roots and modules, finds what
    the port's finds at its defaults: nothing."""
    cfg = dict(roots=list(lint.DEFAULT_ROOTS), repo_root=REPO,
               clock_modules=lint.CLOCK_MODULES,
               netio_modules=lint.NETIO_MODULES,
               metrics_source=os.path.join(REPO, lint.METRICS_SOURCE))
    assert lint.lint(lint.Config(**cfg)) == ([], [])
    assert jax_lint.lint(jax_lint.Config(**cfg)) == ([], [])
