"""Machine (mu) state: pc, stack, memory, interval gas accounting
(capability parity: mythril/laser/ethereum/state/machine_state.py:30-263)."""

from copy import copy
from typing import Any, List, Union

from ...smt import BitVec, Bool, Expression, If, symbol_factory
from ...support.eth_constants import (
    BLOCK_GAS_LIMIT,
    GAS_MEMORY,
    GAS_MEMORY_QUADRATIC_DENOMINATOR,
    STACK_LIMIT,
    ceil32,
)
from ..evm_exceptions import (
    OutOfGasException,
    StackOverflowException,
    StackUnderflowException,
)
from .memory import Memory


def _coerce_word(element: Union[int, Expression]) -> Expression:
    """Stack entries are 256-bit words: raw ints intern to constants,
    Bools lower to 0/1 words (the MachineStack.append contract every
    instruction handler relies on)."""
    if isinstance(element, int):
        return symbol_factory.BitVecVal(element, 256)
    if isinstance(element, Bool):
        return If(
            element,
            symbol_factory.BitVecVal(1, 256),
            symbol_factory.BitVecVal(0, 256),
        )
    return element


def _memory_fee(size_bytes: int) -> int:
    """Total memory fee for a region of `size_bytes` (yellow-paper
    quadratic formula; the extension fee is the difference of two of
    these, matching the reference's pyethereum-derived accounting,
    machine_state.py:137-167)."""
    words = size_bytes // 32
    return words * GAS_MEMORY + words**2 // GAS_MEMORY_QUADRATIC_DENOMINATOR


class MachineStack(list):
    """EVM stack: 1024-entry limit, automatic wrapping of raw ints/Bools
    into 256-bit BitVecs on push."""

    STACK_LIMIT = STACK_LIMIT

    def __init__(self, default_list=None) -> None:
        super().__init__(default_list or [])

    def append(self, element: Union[int, Expression]) -> None:
        if list.__len__(self) >= self.STACK_LIMIT:
            raise StackOverflowException(
                "Reached the EVM stack limit, you can't append more elements"
            )
        super().append(_coerce_word(element))

    def pop(self, index=-1) -> Union[int, Expression]:
        try:
            return super().pop(index)
        except IndexError:
            raise StackUnderflowException(
                "Trying to pop from an empty stack"
            )

    def __getitem__(self, item: Union[int, slice]) -> Any:
        try:
            return super().__getitem__(item)
        except IndexError:
            raise StackUnderflowException(
                "Trying to access a stack element which doesn't exist"
            )

    def __add__(self, other):
        raise NotImplementedError("Implement this if needed")

    def __iadd__(self, other):
        raise NotImplementedError("Implement this if needed")

    def __copy__(self) -> "MachineStack":
        # one C-level bulk copy: without this, copy() routes through
        # pickle-reduce and re-invokes the overridden append (limit
        # check + word coercion) per element — on the fork hot path
        new = MachineStack.__new__(MachineStack)
        list.extend(new, self)
        return new


class MachineState:
    """The machine state of one execution path."""

    def __init__(
        self,
        gas_limit: int,
        pc=0,
        stack=None,
        subroutine_stack=None,
        memory: Memory = None,
        constraints=None,
        depth=0,
        max_gas_used=0,
        min_gas_used=0,
        prev_pc=-1,
    ) -> None:
        self.pc = pc
        self.stack = MachineStack(stack)
        self.subroutine_stack = MachineStack(subroutine_stack)
        self.memory = memory or Memory()
        self.gas_limit = gas_limit
        self.min_gas_used = min_gas_used
        self.max_gas_used = max_gas_used
        self.depth = depth
        self.prev_pc = prev_pc  # pc of the previously executed instruction

    def calculate_extension_size(self, start: int, size: int) -> int:
        if self.memory_size > start + size:
            return 0
        return ceil32(start + size) - self.memory_size

    def calculate_memory_gas(self, start: int, size: int) -> int:
        """Extension fee for growing memory to cover [start, start+size)."""
        return _memory_fee(ceil32(start + size)) - _memory_fee(
            self.memory_size
        )

    def check_gas(self) -> None:
        if self.min_gas_used > self.gas_limit:
            raise OutOfGasException()

    def mem_extend(self, start: Union[int, BitVec],
                   size: Union[int, BitVec]) -> None:
        """Extend memory (and account gas) for an access at [start,
        start+size). Symbolic bounds leave memory untouched (the
        reference behaves identically: only concrete accesses extend)."""
        if isinstance(start, BitVec):
            if start.symbolic:
                return
            start = start.value
        if isinstance(size, BitVec):
            if size.symbolic:
                return
            size = size.value
        if size <= 0:
            return
        m_extend = self.calculate_extension_size(start, size)
        if not m_extend:
            return
        extend_gas = self.calculate_memory_gas(start, size)
        self.min_gas_used += extend_gas
        self.max_gas_used += extend_gas
        self.check_gas()
        self.memory.extend(m_extend)

    def memory_write(self, offset: int, data: List[int]) -> None:
        self.mem_extend(offset, len(data))
        self.memory[offset : offset + len(data)] = data

    def pop(self, amount=1) -> Union[BitVec, List[BitVec]]:
        """Pop `amount` items; a single item when amount==1."""
        if amount > len(self.stack):
            raise StackUnderflowException
        values = self.stack[-amount:][::-1]
        del self.stack[-amount:]
        return values[0] if amount == 1 else values

    @property
    def memory_size(self) -> int:
        return len(self.memory)

    def __deepcopy__(self, memodict=None) -> "MachineState":
        # field-by-field via __new__ (one mstate copy per GlobalState
        # fork — the constructor would re-wrap the stacks)
        new = MachineState.__new__(MachineState)
        new.pc = self.pc
        new.stack = copy(self.stack)
        new.subroutine_stack = copy(self.subroutine_stack)
        new.memory = copy(self.memory)
        new.gas_limit = self.gas_limit
        new.min_gas_used = self.min_gas_used
        new.max_gas_used = self.max_gas_used
        new.depth = self.depth
        new.prev_pc = self.prev_pc
        return new

    def __str__(self):
        return str(self.as_dict)

    @property
    def as_dict(self) -> dict:
        return dict(
            pc=self.pc,
            stack=self.stack,
            subroutine_stack=self.subroutine_stack,
            memory=self.memory,
            memsize=self.memory_size,
            gas=self.gas_limit,
        )
