"""Device operations a training step launched in the profiled period
(device trace)."""


def read(v: dict):
    if "steps" not in v or "kernels" not in v:
        return None
    return len(v["kernels"]) / v["slice"]["steps"]
