"""``python -m repro_torch.sim`` — conformance-sweep the scenario library."""

from .scenarios import main

if __name__ == "__main__":
    raise SystemExit(main())
