from .base import DetectionModule, EntryPoint
from .loader import ModuleLoader
from .util import get_detection_module_hooks, reset_callback_modules
