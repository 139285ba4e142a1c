from .elastic import ElasticTrainer  # noqa: F401
from .watchdog import StepMonitor, StragglerPolicy  # noqa: F401
