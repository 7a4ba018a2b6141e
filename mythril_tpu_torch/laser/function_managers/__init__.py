from .exponent_function_manager import (
    ExponentFunctionManager,
    exponent_function_manager,
)
from .keccak_function_manager import (
    KeccakFunctionManager,
    keccak_function_manager,
)

__all__ = [
    "ExponentFunctionManager",
    "exponent_function_manager",
    "KeccakFunctionManager",
    "keccak_function_manager",
]
