from .elastic import DeviceLoss, ElasticTrainer, surviving_mesh  # noqa: F401
from .watchdog import StepMonitor, StragglerPolicy  # noqa: F401
