from .vera_config import VeRAConfig  # noqa: F401
from .vera_model import VeRAModel  # noqa: F401
