"""launches_per_fleet_step: device operations (kernels, copies,
memsets) launched inside each traced ``DecodeEngine.step()``, averaged
over the traced fleet steps."""


def read(run):
    t = run.trace
    if t is None or not t.iterations["fleet_step"]:
        return None
    steps = t.iterations["fleet_step"]
    return sum(len(ops) for ops in steps) / len(steps)
