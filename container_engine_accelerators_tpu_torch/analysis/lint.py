"""AST invariant lint engine: the project rules, as one registry.

The port's copy of ``container_engine_accelerators_tpu/analysis/
lint.py``: the same rules, suppression grammar and exit codes, with
defaults that lint the port's package (its ``cmd/`` included) against
the repo's ``README.md``.  Run it with ``python -m
container_engine_accelerators_tpu_torch.cmd.agent_lint``.

Previous PRs each learned an invariant the hard way and pinned it with
an ad-hoc test (the no-undocumented-counters README lint buried in
``tests/test_obs.py`` was the first); this module generalizes that into
a pluggable rule framework over the package's ASTs so every invariant
lives in ONE registry, runs from ONE gate (``cmd/agent_lint.py``),
and fails with a ``file:line`` finding instead
of a tribal-knowledge review comment.

Rules (each a ``@rule`` function; ``--list-rules`` prints this table):

- ``raw-socket-send``     — ``.sendall(...)`` outside ``utils/netio``:
  the bench rig's loopback stack truncates large single-syscall
  payloads, so every send must ride the capped short-write-proof
  helpers (a lesson learned at ``nri/mux.py``).
- ``naive-clock``         — wall-clock reads (``time.time()``,
  ``datetime.now()``) in modules whose contract is injectable clocks
  (``obs/timeseries.py``, ``utils/retry.py``): tests drive those
  clocks; a stray wall read re-introduces sleep-based flakiness.
- ``bare-except``         — ``except:`` swallows ``KeyboardInterrupt``
  and ``SystemExit``; name the exceptions.
- ``swallowed-exception`` — a broad catch (``Exception`` or wider)
  whose whole body is ``pass``/``continue``: in a daemon thread body
  that silently eats the error that should have fed a counter or the
  flight recorder.
- ``thread-daemon``       — ``threading.Thread(...)`` without an
  explicit ``daemon=``: lifetime must be a decision, not a default.
- ``unjoined-thread``     — ``threading.Thread(...).start()`` as one
  expression with ``daemon`` not ``True``: a non-daemon thread nobody
  holds a reference to can never be joined and will wedge interpreter
  shutdown.
- ``undocumented-metric`` — every literal ``counters.inc`` /
  ``histo.observe`` / ``trace.span(histogram=...)`` /
  ``timeseries.record|gauge|gauge_add`` name, and every gauge family
  the MetricServer exports, must appear backticked in the README
  metrics tables (placeholder segments — ``{x}`` in source, ``<x>`` in
  the README — compare as wildcards).
- ``undocumented-span``   — every span-name literal passed to
  ``trace.span`` / ``trace.event`` / ``trace.record_span`` must
  appear backticked in the README span table (same registry and
  placeholder machinery as ``undocumented-metric``): the span
  vocabulary IS an API — ``agent_trace --critical-path``, the
  critical-path shapes, and the fleet report all key on it.

Suppressions are inline and must name their rule:
``# lint: disable=<rule>[,<rule>...]`` on the finding's line.

Exit-code contract (the CI gate): 0 clean, 1 findings, 2 internal
error (unreadable path, syntax error in a linted file).  Stdlib-only,
like everything else in analysis/.
"""

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# The port's package; its cmd/ is inside it.
DEFAULT_ROOTS = ("container_engine_accelerators_tpu_torch",)

# Modules whose public functions take injectable clocks (``now=`` /
# ``sleep=`` / ``monotonic=`` parameters) — wall-clock reads inside
# them break the test contract.  Matched by repo-relative path suffix.
CLOCK_MODULES = (
    "container_engine_accelerators_tpu_torch/obs/timeseries.py",
    "container_engine_accelerators_tpu_torch/utils/retry.py",
)

# The one module allowed to touch raw socket send primitives.
NETIO_MODULES = (
    "container_engine_accelerators_tpu_torch/utils/netio.py",
)

METRICS_SOURCE = "container_engine_accelerators_tpu_torch/metrics/metrics.py"

SUPPRESS_RE = re.compile(r"#\s*lint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


class Config:
    """Where to look and which modules carry special contracts.  The
    defaults lint the shipped package; tests override with synthetic
    roots/snippets."""

    def __init__(self,
                 roots: Optional[Iterable[str]] = None,
                 repo_root: str = REPO_ROOT,
                 readme: Optional[str] = None,
                 clock_modules: Iterable[str] = CLOCK_MODULES,
                 netio_modules: Iterable[str] = NETIO_MODULES,
                 metrics_source: Optional[str] = None):
        self.repo_root = repo_root
        self.roots = [os.path.join(repo_root, r) if not os.path.isabs(r)
                      else r
                      for r in (roots if roots is not None
                                else DEFAULT_ROOTS)]
        self.readme = (readme if readme is not None
                       else os.path.join(repo_root, "README.md"))
        self.clock_modules = tuple(clock_modules)
        self.netio_modules = tuple(netio_modules)
        if metrics_source is None:
            cand = os.path.join(repo_root, METRICS_SOURCE)
            metrics_source = cand if os.path.exists(cand) else ""
        self.metrics_source = metrics_source

    def relpath(self, path: str) -> str:
        ap = os.path.abspath(path)
        if ap.startswith(self.repo_root + os.sep):
            return ap[len(self.repo_root) + 1:].replace(os.sep, "/")
        return ap.replace(os.sep, "/")

    def _suffix_match(self, path: str, entries: Iterable[str]) -> bool:
        rel = self.relpath(path)
        return any(rel == e or rel.endswith("/" + e) for e in entries)

    def is_clock_module(self, path: str) -> bool:
        return self._suffix_match(path, self.clock_modules)

    def is_netio_module(self, path: str) -> bool:
        return self._suffix_match(path, self.netio_modules)


# ---------------------------------------------------------------------------
# rule registry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Rule:
    name: str
    doc: str
    check: Callable
    project: bool = False  # project rules see the whole file set once


RULES: Dict[str, Rule] = {}


def rule(name: str, doc: str, project: bool = False):
    def register(fn):
        RULES[name] = Rule(name, doc, fn, project)
        return fn
    return register


# -- AST helpers -------------------------------------------------------------


def _literal_name(node) -> Optional[str]:
    """A metric-name argument as a normalized string: plain constants
    stay themselves; f-string placeholders become ``<>`` wildcards.
    None for anything dynamic (a variable is not a *name literal*)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            if isinstance(v, ast.Constant):
                parts.append(str(v.value))
            else:
                parts.append("<>")
        return "".join(parts)
    return None


def normalize_placeholders(name: str) -> str:
    """``fault.fired.{site}`` / ``fault.fired.<site>`` -> a comparable
    ``fault.fired.<>`` — how source-side f-strings and README-side
    placeholder rows agree on one spelling."""
    return re.sub(r"\{[^}]*\}|<[^>]*>", "<>", name)


def _attr_chain(node) -> List[str]:
    """``a.b.c`` -> ["a", "b", "c"]; empty when the base is a call or
    subscript (dynamic)."""
    out: List[str] = []
    while isinstance(node, ast.Attribute):
        out.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        out.append(node.id)
        out.reverse()
        return out
    return []


def _is_thread_call(call: ast.Call) -> bool:
    chain = _attr_chain(call.func)
    return chain[-2:] == ["threading", "Thread"] or chain == ["Thread"]


def _daemon_kw(call: ast.Call) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == "daemon":
            return kw.value
    return None


# -- per-file rules ----------------------------------------------------------


@rule("raw-socket-send",
      "raw .sendall() outside utils/netio — large single-syscall sends "
      "truncate on this rig; use netio.sendall/sendall_parts")
def _raw_socket_send(tree, cfg: Config, path: str):
    if cfg.is_netio_module(path):
        return
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "sendall"):
            continue
        chain = _attr_chain(node.func)
        # netio.sendall(...) / utils.netio.sendall(...) are the fix,
        # not the finding.
        if len(chain) >= 2 and chain[-2] == "netio":
            continue
        yield Finding(
            "raw-socket-send", path, node.lineno,
            "raw .sendall() — route through "
            "utils/netio.sendall (short-write hardened, capped per "
            "syscall)")


@rule("naive-clock",
      "wall-clock read in an injectable-clock module — take now=/"
      "sleep= parameters instead")
def _naive_clock(tree, cfg: Config, path: str):
    if not cfg.is_clock_module(path):
        return
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        if chain[-2:] == ["time", "time"] or (
                chain and chain[0] == "datetime"
                and chain[-1] in ("now", "utcnow", "today")):
            yield Finding(
                "naive-clock", path, node.lineno,
                f"{'.'.join(chain)}() in a module whose contract is "
                f"injectable clocks — accept a now=/monotonic= "
                f"parameter")


@rule("bare-except",
      "bare except: swallows KeyboardInterrupt/SystemExit — name the "
      "exceptions")
def _bare_except(tree, cfg: Config, path: str):
    for node in ast.walk(tree):
        if isinstance(node, ast.ExceptHandler) and node.type is None:
            yield Finding(
                "bare-except", path, node.lineno,
                "bare except: — catch explicit exception types")


_BROAD = {"Exception", "BaseException"}


def _is_broad(type_node) -> bool:
    if type_node is None:
        return True
    if isinstance(type_node, ast.Name):
        return type_node.id in _BROAD
    if isinstance(type_node, ast.Tuple):
        return any(_is_broad(e) for e in type_node.elts)
    return False


@rule("swallowed-exception",
      "broad except whose body is only pass/continue — a daemon "
      "thread dies silently; log it or feed a counter")
def _swallowed(tree, cfg: Config, path: str):
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not _is_broad(node.type):
            continue
        if all(isinstance(s, (ast.Pass, ast.Continue)) for s in node.body):
            yield Finding(
                "swallowed-exception", path, node.lineno,
                "broad exception silently swallowed — log, count "
                "(metrics/counters), or narrow the type")


@rule("thread-daemon",
      "threading.Thread without an explicit daemon= — thread lifetime "
      "must be a decision, not a default")
def _thread_daemon(tree, cfg: Config, path: str):
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and _is_thread_call(node)
                and _daemon_kw(node) is None):
            yield Finding(
                "thread-daemon", path, node.lineno,
                "threading.Thread(...) without daemon= — decide (and "
                "document) whether this thread may outlive its owner")


@rule("unjoined-thread",
      "threading.Thread(...).start() fire-and-forget with daemon not "
      "True — nobody can ever join it")
def _unjoined(tree, cfg: Config, path: str):
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
                and isinstance(node.value.func, ast.Attribute)
                and node.value.func.attr == "start"
                and isinstance(node.value.func.value, ast.Call)
                and _is_thread_call(node.value.func.value)):
            continue
        daemon = _daemon_kw(node.value.func.value)
        if (isinstance(daemon, ast.Constant) and daemon.value is True):
            continue
        yield Finding(
            "unjoined-thread", path, node.lineno,
            "non-daemon Thread(...).start() with no reference kept — "
            "keep the handle and join it, or mark daemon=True")


# -- project rule: the metric surface vs. the README -------------------------


def metric_names(files: Iterable[str]) -> Dict[str, List[Tuple[str, str,
                                                               int]]]:
    """Every literal metric name in ``files`` by category:
    ``{"counter"|"histogram"|"series": [(name, path, line), ...]}``.
    Categories map to README spellings: counters/series normalize
    f-string placeholders to wildcards, same as README ``<x>``
    segments."""
    out: Dict[str, List[Tuple[str, str, int]]] = {
        "counter": [], "histogram": [], "series": [],
    }
    for path in files:
        try:
            with open(path) as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            arg0 = _literal_name(node.args[0]) if node.args else None
            if chain[-2:] == ["counters", "inc"] and arg0:
                out["counter"].append((arg0, path, node.lineno))
            elif chain[-2:] == ["histo", "observe"] and arg0:
                out["histogram"].append((arg0, path, node.lineno))
            elif (len(chain) >= 2 and chain[-2] == "timeseries"
                    and chain[-1] in ("record", "gauge", "gauge_add")
                    and arg0):
                out["series"].append((arg0, path, node.lineno))
            for kw in node.keywords:
                if kw.arg == "histogram":
                    name = _literal_name(kw.value)
                    if name:
                        out["histogram"].append((name, path,
                                                 node.lineno))
    return out


def span_names(files: Iterable[str]) -> List[Tuple[str, str, int]]:
    """Every literal span name passed to ``trace.span`` /
    ``trace.event`` / ``trace.record_span`` in ``files``, as
    ``(name, path, line)``.  F-string placeholders normalize to
    wildcards like metric names; dynamic names are not literals and
    are skipped."""
    out: List[Tuple[str, str, int]] = []
    for path in files:
        try:
            with open(path) as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError):
            continue
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            chain = _attr_chain(node.func)
            if chain[-2:] not in (["trace", "span"],
                                  ["trace", "event"],
                                  ["trace", "record_span"]):
                continue
            name = _literal_name(node.args[0]) if node.args else None
            if name:
                out.append((name, path, node.lineno))
    return out


@rule("undocumented-span",
      "span-name literal missing from the README span table — the "
      "span vocabulary is an API (critical-path shapes, agent_trace) "
      "and every name is documented",
      project=True)
def _undocumented_span(files: List[str], cfg: Config):
    documented = documented_tokens(cfg.readme)
    # Every sighting is its own finding (line-scoped suppressions,
    # same rationale as undocumented-metric).
    for name, path, line in span_names(files):
        norm = normalize_placeholders(name)
        if norm in documented:
            continue
        yield Finding(
            "undocumented-span", cfg.relpath(path), line,
            f"span name {name!r} is not documented in "
            f"{os.path.basename(cfg.readme)} — add it to the span "
            f"table (placeholders may be spelled <x>)")


def gauge_families(metrics_source: str) -> Set[str]:
    """Gauge families straight from the exporter source — the
    ``g("name"`` helper calls in ``MetricServer.__init__``."""
    if not metrics_source or not os.path.exists(metrics_source):
        return set()
    src = open(metrics_source).read()
    return set(re.findall(r"\bg\(\s*\n?\s*\"([a-z_]+)\"", src))


def documented_tokens(readme_path: str) -> Set[str]:
    """Every backticked token in the README, placeholder-normalized —
    the document side of the documented-or-fail bar."""
    try:
        readme = open(readme_path).read()
    except OSError:
        return set()
    return {normalize_placeholders(tok)
            for tok in re.findall(r"`([^`\n]+)`", readme)}


@rule("undocumented-metric",
      "counter/histogram/series/gauge-family name missing from the "
      "README metrics tables — every exported name is documented",
      project=True)
def _undocumented_metric(files: List[str], cfg: Config):
    documented = documented_tokens(cfg.readme)
    names = metric_names(files)
    # Every sighting is its own finding: suppressions are line-scoped,
    # so deduping by name here would let one suppressed site hide an
    # un-suppressed use of the same undocumented name elsewhere.
    for kind, entries in names.items():
        for name, path, line in entries:
            norm = normalize_placeholders(name)
            if norm in documented:
                continue
            yield Finding(
                "undocumented-metric", cfg.relpath(path), line,
                f"{kind} name {name!r} is not documented in "
                f"{os.path.basename(cfg.readme)} — add a metrics-table "
                f"row (placeholders may be spelled <x>)")
    for fam in sorted(gauge_families(cfg.metrics_source)):
        if fam not in documented:
            yield Finding(
                "undocumented-metric", cfg.relpath(cfg.metrics_source), 1,
                f"exported gauge family {fam!r} is not documented in "
                f"{os.path.basename(cfg.readme)}")


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


def iter_py_files(roots: Iterable[str]) -> List[str]:
    out: List[str] = []
    for root in roots:
        if os.path.isfile(root):
            out.append(root)
            continue
        for dirpath, dirnames, files in os.walk(root):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for f in sorted(files):
                if f.endswith(".py") and not f.endswith("_pb2.py"):
                    out.append(os.path.join(dirpath, f))
    return sorted(out)


def _suppressions(src: str) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        m = SUPPRESS_RE.search(line)
        if m:
            out[i] = {r.strip() for r in m.group(1).split(",")
                      if r.strip()}
    return out


def lint_file(path: str, cfg: Config,
              rules: Optional[Iterable[str]] = None,
              src: Optional[str] = None,
              supp: Optional[Dict[int, Set[str]]] = None) -> List[Finding]:
    """Per-file rules over one source file, suppressions applied.
    Raises OSError/SyntaxError to the caller — an unlintable file is
    an internal error (exit 2), not a silent skip.  ``src``/``supp``
    let a caller that already read and scanned the file skip doing
    either twice."""
    if src is None:
        with open(path) as fh:
            src = fh.read()
    tree = ast.parse(src, filename=path)
    if supp is None:
        supp = _suppressions(src)
    findings: List[Finding] = []
    for r in RULES.values():
        if r.project or (rules is not None and r.name not in rules):
            continue
        for f in r.check(tree, cfg, cfg.relpath(path)):
            if r.name not in supp.get(f.line, ()):
                findings.append(f)
    return findings


def lint(cfg: Optional[Config] = None,
         rules: Optional[Iterable[str]] = None,
         ) -> Tuple[List[Finding], List[str]]:
    """The whole gate: every per-file rule over every file under
    ``cfg.roots``, then the project rules over the file set.  Returns
    (findings, internal_errors)."""
    cfg = cfg or Config()
    rules = set(rules) if rules is not None else None
    files = iter_py_files(cfg.roots)
    findings: List[Finding] = []
    errors: List[str] = []
    suppressions: Dict[str, Dict[int, Set[str]]] = {}
    for path in files:
        try:
            with open(path) as fh:
                src = fh.read()
            supp = suppressions[cfg.relpath(path)] = _suppressions(src)
            findings.extend(lint_file(path, cfg, rules, src=src,
                                      supp=supp))
        except (OSError, SyntaxError) as e:
            errors.append(f"{path}: {e}")
    for r in RULES.values():
        if not r.project or (rules is not None and r.name not in rules):
            continue
        for f in r.check(files, cfg):
            supp = suppressions.get(f.path, {})
            if r.name not in supp.get(f.line, ()):
                findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings, errors
