"""Top-level exception types (reference parity: mythril/exceptions.py)."""


class MythrilBaseException(Exception):
    """The base exception for the framework."""


class CompilerError(MythrilBaseException):
    """Solidity compilation failure."""


class UnsatError(MythrilBaseException):
    """Constraint set has no solution."""


class SolverTimeOutException(UnsatError):
    """Solver query timed out."""


class NoContractFoundError(MythrilBaseException):
    """Input file contains no contract."""


class CriticalError(MythrilBaseException):
    """Fatal user-facing error."""


class AddressNotFoundError(MythrilBaseException):
    """Contract address not found on chain."""


class DetectorNotFoundError(MythrilBaseException):
    """Unknown detection module requested."""


class IllegalArgumentError(ValueError):
    """Invalid argument combination."""
