"""fleet_step_ms: host milliseconds of ``DecodeEngine.step()`` (one
decode step for every lane; it ends reading the step's tokens), total
over count in the window."""


def read(run):
    steps = run.spans["fleet_step"]
    return 1e3 * sum(steps) / len(steps) if steps else None
