"""FL simulation (port of ``repro.sim``): ``Simulator(SimConfig(...)).run()``."""
from repro_torch.sim.engine import SimConfig, Simulator, Substrate  # noqa: F401
