"""VM exception hierarchy (reference parity:
mythril/laser/ethereum/evm_exceptions.py:4-42)."""


class VmException(Exception):
    """The base VM exception."""


class StackUnderflowException(IndexError, VmException):
    """A stack underflow."""


class StackOverflowException(VmException):
    """A stack overflow."""


class InvalidJumpDestination(VmException):
    """An invalid jump destination."""


class InvalidInstruction(VmException):
    """An invalid instruction."""


class OutOfGasException(VmException):
    """An out-of-gas condition."""


class WriteProtection(VmException):
    """A write attempt inside a static call."""
