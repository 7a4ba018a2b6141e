"""Symbolic EVM instruction semantics (capability parity:
mythril/laser/ethereum/instructions.py — one handler per opcode, pre/post
hook points, interval gas accounting, transaction signals for the
CALL/CREATE family).

Own architecture notes: handlers are methods named `<op>_` / `<op>_post`
resolved by a mangling table, wrapped by StateTransition which (1) rejects
state-mutating ops inside STATICCALL frames, (2) copies the incoming state,
(3) accumulates [min,max] gas and enforces the gas limit, (4) increments the
pc. Forks (JUMPI) append path conditions to world_state.constraints and
return multiple states.
"""

import logging
from copy import copy, deepcopy
from typing import Callable, Dict, List, Optional, Tuple, Union

from ..smt import (
    And,
    BitVec,
    Bool,
    Concat,
    Expression,
    Extract,
    Not,
    Or,
    UGE,
    ULE,
    simplify,
    symbol_factory,
)
from ..support.support_args import args as global_args
from . import alu, util
from .call import (
    SYMBOLIC_CALLDATA_SIZE,
    get_call_data,
    get_call_parameters,
    get_callee_account,
    native_call,
)
from .evm_exceptions import (
    InvalidInstruction,
    InvalidJumpDestination,
    OutOfGasException,
    StackUnderflowException,
    VmException,
    WriteProtection,
)
from .function_managers import (
    exponent_function_manager,
    keccak_function_manager,
)
from .instruction_data import calculate_sha3_gas, get_opcode_gas
from .state.calldata import ConcreteCalldata, SymbolicCalldata
from .state.global_state import GlobalState
from .state.return_data import ReturnData
from .transaction import (
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
    tx_id_manager,
)

log = logging.getLogger(__name__)



def transfer_ether(
    global_state: GlobalState,
    sender: BitVec,
    receiver: BitVec,
    value: Union[int, BitVec],
):
    """Moves value between accounts, constraining sender solvency
    (reference instructions.py:74-95)."""
    value = (
        value
        if isinstance(value, BitVec)
        else symbol_factory.BitVecVal(value, 256)
    )
    global_state.world_state.constraints.append(
        UGE(global_state.world_state.balances[sender], value)
    )
    global_state.world_state.balances[receiver] += value
    global_state.world_state.balances[sender] -= value


class StateTransition(object):
    """Decorator handling state copy, gas accounting and pc increment."""

    def __init__(self, increment_pc=True, enable_gas=True,
                 is_state_mutation_instruction=False):
        self.increment_pc = increment_pc
        self.enable_gas = enable_gas
        self.is_state_mutation_instruction = is_state_mutation_instruction

    def check_gas_usage_limit(self, global_state: GlobalState):
        global_state.mstate.check_gas()
        if isinstance(global_state.current_transaction.gas_limit, BitVec):
            value = global_state.current_transaction.gas_limit.value
            if value is None:
                return
            global_state.current_transaction.gas_limit = value
        if (
            global_state.mstate.min_gas_used
            >= global_state.current_transaction.gas_limit
        ):
            raise OutOfGasException()

    def accumulate_gas(self, global_state: GlobalState):
        if not self.enable_gas:
            return global_state
        opcode = global_state.instruction["opcode"]
        min_gas, max_gas = get_opcode_gas(opcode)
        global_state.mstate.min_gas_used += min_gas
        global_state.mstate.max_gas_used += max_gas
        self.check_gas_usage_limit(global_state)
        return global_state

    def __call__(self, func: Callable) -> Callable:
        def wrapper(func_obj: "Instruction",
                    global_state: GlobalState) -> List[GlobalState]:
            if (
                self.is_state_mutation_instruction
                and global_state.environment.static
            ):
                raise WriteProtection(
                    "The function {} cannot be executed in a static call"
                    .format(func.__name__[:-1])
                )
            new_global_states = func(func_obj, copy(global_state))
            new_global_states = [
                self.accumulate_gas(state) for state in new_global_states
            ]
            if self.increment_pc:
                for state in new_global_states:
                    state.mstate.pc += 1
            return new_global_states

        wrapper.__name__ = func.__name__
        return wrapper


class Instruction:
    """Instruction dispatcher: executes one opcode on one state."""

    def __init__(self, op_code: str, dynamic_loader=None, pre_hooks=None,
                 post_hooks=None):
        self.dynamic_loader = dynamic_loader
        self.op_code = op_code.upper()
        self.pre_hook = pre_hooks if pre_hooks else []
        self.post_hook = post_hooks if post_hooks else []

    def _handler_name(self, post: bool) -> str:
        op = self.op_code.lower()
        if op.startswith("push"):
            op = "push"
        elif op.startswith("dup"):
            op = "dup"
        elif op.startswith("swap"):
            op = "swap"
        elif op.startswith("log"):
            op = "log"
        return op + ("_post" if post else "_")

    def evaluate(self, global_state: GlobalState,
                 post=False) -> List[GlobalState]:
        """Execute the instruction (or its post-resume handler)."""
        log.debug("Evaluating %s at %i", self.op_code, global_state.mstate.pc)
        name = self._handler_name(post)
        instruction_mutator = getattr(self, name, None)
        if instruction_mutator is None:
            raise NotImplementedError(self.op_code)

        global_state.mstate.prev_pc = global_state.mstate.pc
        for hook in self.pre_hook:
            hook(global_state)
        result = instruction_mutator(global_state)
        for hook in self.post_hook:
            hook(result)
        return result

    # -- arithmetic ---------------------------------------------------------

    @StateTransition()
    def add_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.add(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def sub_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.sub(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def mul_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.mul(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def div_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.div(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def sdiv_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.sdiv(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def mod_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.mod(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def smod_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.smod(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def addmod_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.addmod(
                util.pop_bitvec(state),
                util.pop_bitvec(state),
                util.pop_bitvec(state),
            )
        )
        return [global_state]

    @StateTransition()
    def mulmod_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.mulmod(
                util.pop_bitvec(state),
                util.pop_bitvec(state),
                util.pop_bitvec(state),
            )
        )
        return [global_state]

    @StateTransition()
    def exp_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        base, exponent = util.pop_bitvec(state), util.pop_bitvec(state)
        result, constraint = alu.exp(base, exponent)
        state.stack.append(result)
        if constraint is not None:
            global_state.world_state.constraints.append(constraint)
        return [global_state]

    @StateTransition()
    def signextend_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.signextend(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    # -- comparison / bitwise ----------------------------------------------

    @StateTransition()
    def lt_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.lt(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def gt_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.gt(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def slt_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.slt(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def sgt_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.sgt(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def eq_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(alu.eq(state.stack.pop(), state.stack.pop()))
        return [global_state]

    @StateTransition()
    def iszero_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(alu.iszero(state.stack.pop()))
        return [global_state]

    @StateTransition()
    def and_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.and_(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def or_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.or_(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def xor_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.xor(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def not_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(alu.not_(util.pop_bitvec(state)))
        return [global_state]

    @StateTransition()
    def byte_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.byte_op(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def shl_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.shl(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def shr_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.shr(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    @StateTransition()
    def sar_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.stack.append(
            alu.sar(util.pop_bitvec(state), util.pop_bitvec(state))
        )
        return [global_state]

    # -- SHA3 ---------------------------------------------------------------

    @StateTransition(enable_gas=False)
    def sha3_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        index, length = util.pop_bitvec(state), util.pop_bitvec(state)

        if length.symbolic:
            # concretize symbolic lengths to 64 bytes (two words), the
            # dominant mapping-slot pattern (reference
            # instructions.py:1013-1051)
            global_state.world_state.constraints.append(length == 64)
            length = symbol_factory.BitVecVal(64, 256)
        length_val = length.value

        min_gas, max_gas = calculate_sha3_gas(length_val)
        state.min_gas_used += min_gas
        state.max_gas_used += max_gas
        StateTransition(increment_pc=False).check_gas_usage_limit(
            global_state
        )
        state.mem_extend(index, length_val)

        if length_val == 0:
            state.stack.append(
                keccak_function_manager.get_empty_keccak_hash()
            )
            return [global_state]

        if index.symbolic:
            # symbolic memory offset: the bytes hashed are unknowable, so
            # hash a fresh per-site symbolic input (reference
            # instructions.py:1027-1038) rather than reading memory's
            # default-zero bytes at an unresolved address
            data = symbol_factory.BitVecSym(
                f"sha3_input_{tx_id_manager.get_next_tx_id()}",
                length_val * 8,
            )
            result = keccak_function_manager.create_keccak(data)
            state.stack.append(result)
            return [global_state]

        byte_list = [state.memory[index + i] for i in range(length_val)]
        if all(isinstance(b, int) for b in byte_list):
            data = symbol_factory.BitVecVal(
                int.from_bytes(bytes(byte_list), "big"), length_val * 8
            )
        else:
            parts = [
                b if isinstance(b, BitVec)
                else symbol_factory.BitVecVal(b, 8)
                for b in byte_list
            ]
            data = simplify(Concat(parts))
        result = keccak_function_manager.create_keccak(data)
        state.stack.append(result)
        return [global_state]

    # -- environment --------------------------------------------------------

    @StateTransition()
    def address_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.environment.address
        )
        return [global_state]

    @StateTransition()
    def balance_(self, global_state: GlobalState) -> List[GlobalState]:
        address = util.pop_bitvec(global_state.mstate)
        balance = None
        if address.value is not None:
            try:
                balance = global_state.world_state.accounts_exist_or_load(
                    address.value, self.dynamic_loader
                ).balance()
            except ValueError:
                # unknown account without on-chain loading (reference
                # instructions.py:916-929 falls back to an If-chain over
                # known accounts; the global balances array covers that)
                balance = None
        if balance is None:
            balance = global_state.world_state.balances[address]
        global_state.mstate.stack.append(balance)
        return [global_state]

    @StateTransition()
    def origin_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.origin)
        return [global_state]

    @StateTransition()
    def caller_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.sender)
        return [global_state]

    @StateTransition()
    def callvalue_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.environment.callvalue
        )
        return [global_state]

    @StateTransition()
    def calldataload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        op0 = state.stack.pop()
        value = global_state.environment.calldata.get_word_at(op0)
        state.stack.append(value)
        return [global_state]

    @StateTransition()
    def calldatasize_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.environment.calldata.calldatasize
        )
        return [global_state]

    @StateTransition()
    def calldatacopy_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        op0, op1, op2 = (
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
        )
        return self._copy_data_to_memory(
            global_state, global_state.environment.calldata, op0, op1, op2
        )

    def _copy_data_to_memory(self, global_state, source, mstart, dstart,
                             size) -> List[GlobalState]:
        """Copy `size` bytes of `source` (calldata-like) into memory."""
        state = global_state.mstate
        try:
            mstart_v = util.get_concrete_int(mstart)
        except TypeError:
            log.debug("Unsupported symbolic memory offset in copy")
            return [global_state]
        try:
            dstart_v: Union[int, BitVec] = util.get_concrete_int(dstart)
        except TypeError:
            dstart_v = dstart
        try:
            size_v: Union[int, BitVec] = util.get_concrete_int(size)
        except TypeError:
            size_v = SYMBOLIC_CALLDATA_SIZE
        if size_v > 0:
            try:
                state.mem_extend(mstart_v, size_v)
            except TypeError:
                log.debug("Memory allocation error: %s of size %s",
                          mstart_v, size_v)
                state.mem_extend(mstart_v, 1)
                state.memory[mstart_v] = global_state.new_bitvec(
                    "calldata_"
                    + str(global_state.current_transaction.id)
                    + "[" + str(dstart_v) + "]",
                    8,
                )
                return [global_state]
            for i in range(size_v):
                d_index = (
                    dstart_v + i
                    if isinstance(dstart_v, int)
                    else simplify(dstart_v + i)
                )
                state.memory[mstart_v + i] = source[d_index]
        return [global_state]

    @StateTransition()
    def codesize_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        disassembly = global_state.environment.code
        no_of_bytes = len(disassembly.bytecode) // 2
        if isinstance(global_state.current_transaction,
                      ContractCreationTransaction):
            # creation: code size includes appended (symbolic) calldata
            calldata = global_state.environment.calldata
            if isinstance(calldata, ConcreteCalldata):
                no_of_bytes += calldata.size
            else:
                no_of_bytes += 0x200  # default: 512 bytes of arguments
                global_state.world_state.constraints.append(
                    global_state.environment.calldata.calldatasize == 0x200
                )
        state.stack.append(no_of_bytes)
        return [global_state]

    def _handle_symbolic_args(self, global_state, concrete_memory_offset):
        """Creation-code COPY of constructor arguments beyond the bytecode:
        write fresh symbols (the arguments are attacker-chosen)."""
        global_state.mstate.mem_extend(concrete_memory_offset, 32)
        global_state.mstate.memory[concrete_memory_offset] = (
            global_state.new_bitvec(
                f"code_{global_state.current_transaction.id}"
                f"[{concrete_memory_offset}]",
                8,
            )
        )

    @StateTransition()
    def codecopy_(self, global_state: GlobalState) -> List[GlobalState]:
        memory_offset, code_offset, size = (
            global_state.mstate.stack.pop(),
            global_state.mstate.stack.pop(),
            global_state.mstate.stack.pop(),
        )
        return self._code_copy_helper(
            code=global_state.environment.code.bytecode,
            memory_offset=memory_offset,
            code_offset=code_offset,
            size=size,
            op="CODECOPY",
            global_state=global_state,
        )

    def _code_copy_helper(self, code, memory_offset, code_offset, size, op,
                          global_state) -> List[GlobalState]:
        try:
            concrete_memory_offset = util.get_concrete_int(memory_offset)
        except TypeError:
            log.debug("Unsupported symbolic memory offset in %s", op)
            return [global_state]
        try:
            concrete_size = util.get_concrete_int(size)
            global_state.mstate.mem_extend(
                concrete_memory_offset, concrete_size
            )
        except TypeError:
            # except both attribute error and Exception
            global_state.mstate.mem_extend(concrete_memory_offset, 1)
            global_state.mstate.memory[
                concrete_memory_offset
            ] = global_state.new_bitvec(
                "code({})".format(
                    global_state.environment.active_account.contract_name
                ),
                8,
            )
            return [global_state]

        try:
            concrete_code_offset = util.get_concrete_int(code_offset)
        except TypeError:
            log.debug("Unsupported symbolic code offset in %s", op)
            global_state.mstate.mem_extend(
                concrete_memory_offset, concrete_size
            )
            for i in range(concrete_size):
                global_state.mstate.memory[
                    concrete_memory_offset + i
                ] = global_state.new_bitvec(
                    "code({})".format(
                        global_state.environment.active_account
                        .contract_name
                    ),
                    8,
                )
            return [global_state]

        bytecode = code
        if isinstance(bytecode, str):
            bytecode = bytes.fromhex(bytecode.replace("0x", ""))

        if concrete_size == 0 and isinstance(
            global_state.current_transaction, ContractCreationTransaction
        ):
            if concrete_code_offset >= len(bytecode):
                self._handle_symbolic_args(
                    global_state, concrete_memory_offset
                )
                return [global_state]

        for i in range(concrete_size):
            if concrete_code_offset + i < len(bytecode):
                global_state.mstate.memory[concrete_memory_offset + i] = (
                    bytecode[concrete_code_offset + i]
                )
            elif isinstance(
                global_state.current_transaction,
                ContractCreationTransaction,
            ):
                # copying constructor arguments (symbolic calldata appended
                # after the creation code)
                offset = (
                    concrete_code_offset + i - len(bytecode)
                )
                global_state.mstate.memory[concrete_memory_offset + i] = (
                    global_state.environment.calldata[offset]
                )
            else:
                global_state.mstate.memory[concrete_memory_offset + i] = 0
        return [global_state]

    @StateTransition()
    def gasprice_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.environment.gasprice
        )
        return [global_state]

    @StateTransition()
    def basefee_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.basefee)
        return [global_state]

    @StateTransition()
    def extcodesize_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        addr = state.stack.pop()
        try:
            addr = hex(util.get_concrete_int(addr))
        except TypeError:
            log.debug("unsupported symbolic address for EXTCODESIZE")
            state.stack.append(global_state.new_bitvec(
                "extcodesize_" + str(addr), 256))
            return [global_state]
        try:
            code = global_state.world_state.accounts_exist_or_load(
                addr, self.dynamic_loader
            ).code.bytecode
        except (ValueError, AttributeError) as e:
            log.debug("error accessing contract storage: %s", e)
            state.stack.append(global_state.new_bitvec(
                "extcodesize_" + str(addr), 256))
            return [global_state]
        state.stack.append(len(code) // 2)
        return [global_state]

    @StateTransition()
    def extcodecopy_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        addr, memory_offset, code_offset, size = (
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
        )
        try:
            concrete_addr = hex(util.get_concrete_int(addr))
            code = global_state.world_state.accounts_exist_or_load(
                concrete_addr, self.dynamic_loader
            ).code.bytecode
        except (TypeError, ValueError, AttributeError) as e:
            log.debug("error in EXTCODECOPY: %s", e)
            return [global_state]
        return self._code_copy_helper(
            code=code,
            memory_offset=memory_offset,
            code_offset=code_offset,
            size=size,
            op="EXTCODECOPY",
            global_state=global_state,
        )

    @StateTransition()
    def extcodehash_(self, global_state: GlobalState) -> List[GlobalState]:
        world_state = global_state.world_state
        stack = global_state.mstate.stack
        address = Extract(159, 0, stack.pop())

        if address.symbolic:
            stack.append(global_state.new_bitvec(
                f"extcodehash_{str(address)}", 256))
        elif address.value not in world_state.accounts:
            stack.append(symbol_factory.BitVecVal(0, 256))
        else:
            from ..support.support_utils import get_code_hash

            stack.append(
                symbol_factory.BitVecVal(
                    int(
                        get_code_hash(
                            world_state.accounts[address.value].code
                            .bytecode
                        ),
                        16,
                    ),
                    256,
                )
            )
        return [global_state]

    @StateTransition()
    def returndatasize_(self, global_state: GlobalState
                        ) -> List[GlobalState]:
        if global_state.last_return_data is None:
            log.debug(
                "No last_return_data found, adding an unconstrained bitvec"
            )
            global_state.mstate.stack.append(
                global_state.new_bitvec("returndatasize", 256)
            )
        else:
            global_state.mstate.stack.append(
                global_state.last_return_data.return_data_size
            )
        return [global_state]

    @StateTransition()
    def returndatacopy_(self, global_state: GlobalState
                        ) -> List[GlobalState]:
        state = global_state.mstate
        memory_offset, return_offset, size = (
            state.stack.pop(),
            state.stack.pop(),
            state.stack.pop(),
        )
        if global_state.last_return_data is None:
            return [global_state]
        try:
            concrete_memory_offset = util.get_concrete_int(memory_offset)
            concrete_return_offset = util.get_concrete_int(return_offset)
            concrete_size = util.get_concrete_int(size)
        except TypeError:
            log.debug("Unsupported symbolic RETURNDATACOPY arguments")
            return [global_state]
        state.mem_extend(concrete_memory_offset, concrete_size)
        for i in range(concrete_size):
            data = (
                global_state.last_return_data.return_data[
                    concrete_return_offset + i
                ]
                if concrete_return_offset + i
                < len(global_state.last_return_data.return_data)
                else 0
            )
            state.memory[concrete_memory_offset + i] = data
        return [global_state]

    # -- block info ---------------------------------------------------------

    @StateTransition()
    def blockhash_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        blocknumber = state.stack.pop()
        state.stack.append(
            global_state.new_bitvec(
                "blockhash_block_" + str(blocknumber), 256
            )
        )
        return [global_state]

    @StateTransition()
    def coinbase_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.new_bitvec("coinbase", 256)
        )
        return [global_state]

    @StateTransition()
    def timestamp_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            symbol_factory.BitVecSym("timestamp", 256)
        )
        return [global_state]

    @StateTransition()
    def number_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.environment.block_number
        )
        return [global_state]

    @StateTransition()
    def difficulty_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(
            global_state.new_bitvec("block_difficulty", 256)
        )
        return [global_state]

    @StateTransition()
    def gaslimit_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.mstate.gas_limit)
        return [global_state]

    @StateTransition()
    def chainid_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.environment.chainid)
        return [global_state]

    @StateTransition()
    def selfbalance_(self, global_state: GlobalState) -> List[GlobalState]:
        balance = global_state.environment.active_account.balance()
        global_state.mstate.stack.append(balance)
        return [global_state]

    # -- memory / storage / flow -------------------------------------------

    @StateTransition()
    def pop_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.pop()
        return [global_state]

    @StateTransition()
    def mload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        offset = state.stack.pop()
        state.mem_extend(offset, 32)
        data = state.memory.get_word_at(offset)
        if isinstance(data, int):
            data = symbol_factory.BitVecVal(data, 256)
        state.stack.append(data)
        return [global_state]

    @StateTransition()
    def mstore_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        mstart, value = state.stack.pop(), state.stack.pop()
        state.mem_extend(mstart, 32)
        state.memory.write_word_at(mstart, value)
        return [global_state]

    @StateTransition()
    def mstore8_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        offset, value = state.stack.pop(), state.stack.pop()
        state.mem_extend(offset, 1)
        try:
            value_to_write: Union[int, BitVec] = (
                util.get_concrete_int(value) % 256
            )
        except TypeError:
            value_to_write = Extract(7, 0, value)
        state.memory[offset] = value_to_write
        return [global_state]

    @StateTransition()
    def sload_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        index = state.stack.pop()
        state.stack.append(
            global_state.environment.active_account.storage[index]
        )
        return [global_state]

    @StateTransition(is_state_mutation_instruction=True)
    def sstore_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        index, value = state.stack.pop(), state.stack.pop()
        global_state.environment.active_account.storage[index] = value
        return [global_state]

    @StateTransition(increment_pc=False, enable_gas=False)
    def jump_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        disassembly = global_state.environment.code
        try:
            jump_addr = util.get_concrete_int(state.stack.pop())
        except TypeError:
            raise InvalidJumpDestination(
                "Invalid jump argument (symbolic address)"
            )
        except IndexError:
            raise StackUnderflowException()

        index = util.get_instruction_index(
            disassembly.instruction_list, jump_addr
        )
        if index is None:
            raise InvalidJumpDestination("JUMP to invalid address")
        op_code = disassembly.instruction_list[index]["opcode"]
        if op_code != "JUMPDEST":
            raise InvalidJumpDestination(
                "Skipping JUMP to invalid destination (not JUMPDEST): "
                + str(jump_addr)
            )
        min_gas, max_gas = get_opcode_gas("JUMP")
        state.min_gas_used += min_gas
        state.max_gas_used += max_gas
        state.pc = index
        return [global_state]

    @StateTransition(increment_pc=False, enable_gas=False)
    def jumpi_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        disassembly = global_state.environment.code
        min_gas, max_gas = get_opcode_gas("JUMPI")
        states = []

        op0, condition = state.stack.pop(), state.stack.pop()

        try:
            jump_addr = util.get_concrete_int(op0)
        except TypeError:
            log.debug("Skipping JUMPI to invalid destination.")
            state.pc += 1
            state.min_gas_used += min_gas
            state.max_gas_used += max_gas
            return [global_state]

        negated = (
            simplify(Not(condition))
            if isinstance(condition, Bool)
            else condition == 0
        )
        condi = (
            simplify(condition)
            if isinstance(condition, Bool)
            else condition != 0
        )

        negated_cond = not negated.is_false
        positive_cond = not condi.is_false

        if negated_cond:
            # fork: the fall-through side
            new_state = deepcopy(global_state)
            new_state.mstate.min_gas_used += min_gas
            new_state.mstate.max_gas_used += max_gas
            new_state.mstate.depth += 1
            new_state.mstate.pc += 1
            new_state.world_state.constraints.append(negated)
            # manage_cfg labels the CFG edge with this (trivially-true
            # conditions are not kept in the constraint list)
            new_state.branch_condition = negated
            states.append(new_state)
        else:
            log.debug("Pruned unreachable states.")

        index = util.get_instruction_index(
            disassembly.instruction_list, jump_addr
        )
        if index is None:
            log.debug("Invalid jump destination: %s", jump_addr)
            return states
        instr = disassembly.instruction_list[index]
        if instr["opcode"] == "JUMPDEST" and positive_cond:
            new_state = deepcopy(global_state)
            new_state.mstate.min_gas_used += min_gas
            new_state.mstate.max_gas_used += max_gas
            new_state.mstate.depth += 1
            new_state.mstate.pc = index
            new_state.world_state.constraints.append(condi)
            new_state.branch_condition = condi
            states.append(new_state)
        return states

    @StateTransition()
    def beginsub_(self, global_state: GlobalState) -> List[GlobalState]:
        # EIP-2315: a no-op marker when stepped over
        return [global_state]

    @StateTransition()
    def jumpdest_(self, global_state: GlobalState) -> List[GlobalState]:
        return [global_state]

    @StateTransition(increment_pc=False)
    def jumpsub_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        disassembly = global_state.environment.code
        try:
            location = util.get_concrete_int(state.stack.pop())
        except TypeError:
            raise VmException("Encountered symbolic JUMPSUB location")
        index = util.get_instruction_index(
            disassembly.instruction_list, location
        )
        instr = disassembly.instruction_list[index]
        if instr["opcode"] != "BEGINSUB":
            raise VmException(
                "Encountered invalid JUMPSUB location :{}".format(
                    instr["address"]
                )
            )
        state.subroutine_stack.append(state.pc + 1)
        state.pc = index
        return [global_state]

    @StateTransition(increment_pc=False)
    def returnsub_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        state.pc = state.subroutine_stack.pop()
        return [global_state]

    @StateTransition()
    def pc_(self, global_state: GlobalState) -> List[GlobalState]:
        index = global_state.mstate.pc
        program_counter = global_state.environment.code.instruction_list[
            index
        ]["address"]
        global_state.mstate.stack.append(program_counter)
        return [global_state]

    @StateTransition()
    def msize_(self, global_state: GlobalState) -> List[GlobalState]:
        global_state.mstate.stack.append(global_state.mstate.memory_size)
        return [global_state]

    @StateTransition()
    def gas_(self, global_state: GlobalState) -> List[GlobalState]:
        # pushing the gas limit approximates remaining gas soundly for the
        # analyses built on top
        global_state.mstate.stack.append(global_state.mstate.gas_limit)
        return [global_state]

    # -- push / dup / swap / log -------------------------------------------

    @StateTransition()
    def push_(self, global_state: GlobalState) -> List[GlobalState]:
        push_instruction = global_state.get_current_instruction()
        push_value = push_instruction.get("argument", "0x0")
        try:
            length_of_value = 2 * int(
                push_instruction["opcode"][4:]
            )
        except ValueError:
            raise VmException("Invalid Push instruction")
        if isinstance(push_value, (tuple, list, bytes)):
            if all(isinstance(b, int) for b in push_value):
                push_value = "0x" + bytes(push_value).hex()
            else:
                # partially-symbolic immediate (code created from a
                # creation tx whose runtime bytes weren't all concrete):
                # concatenate byte terms (reference
                # instructions.py:292-313)
                parts = [
                    b if isinstance(b, BitVec)
                    else symbol_factory.BitVecVal(b, 8)
                    for b in push_value
                ]
                pad_bytes = length_of_value // 2 - len(parts)
                if pad_bytes > 0:
                    parts.append(symbol_factory.BitVecVal(0, 8 * pad_bytes))
                new_value = Concat(parts) if len(parts) > 1 else parts[0]
                if new_value.size() < 256:
                    new_value = Concat(
                        symbol_factory.BitVecVal(
                            0, 256 - new_value.size()),
                        new_value,
                    )
                global_state.mstate.stack.append(new_value)
                return [global_state]
        push_value += "0" * max(
            length_of_value - (len(push_value) - 2), 0
        )
        global_state.mstate.stack.append(
            symbol_factory.BitVecVal(int(push_value, 16), 256)
        )
        return [global_state]

    @StateTransition()
    def dup_(self, global_state: GlobalState) -> List[GlobalState]:
        value = int(global_state.get_current_instruction()["opcode"][3:],
                    10)
        global_state.mstate.stack.append(
            global_state.mstate.stack[-value]
        )
        return [global_state]

    @StateTransition()
    def swap_(self, global_state: GlobalState) -> List[GlobalState]:
        depth = int(self.op_code[4:])
        stack = global_state.mstate.stack
        stack[-depth - 1], stack[-1] = stack[-1], stack[-depth - 1]
        return [global_state]

    @StateTransition()
    def log_(self, global_state: GlobalState) -> List[GlobalState]:
        state = global_state.mstate
        depth = int(self.op_code[3:])
        state.stack.pop(), state.stack.pop()
        log_data = [state.stack.pop() for _ in range(depth)]
        # events have no effect on the machine state beyond gas
        return [global_state]

    # -- create / call family ----------------------------------------------

    def _create_transaction_helper(self, global_state, call_value,
                                   mem_offset, mem_size, create2_salt=None):
        mstate = global_state.mstate
        environment = global_state.environment
        world_state = global_state.world_state

        try:
            callee_code = mstate.memory[
                util.get_concrete_int(mem_offset) : util.get_concrete_int(
                    mem_offset + mem_size
                )
            ]
        except TypeError:
            log.debug("Create with symbolic length or offset is not "
                      "supported")
            mstate.stack.append(0)
            return [global_state]

        # memory bytes may be concrete BitVec(8) constants (MSTORE writes
        # Extracts of the stored word); fold them before the symbolic check
        from ..support.support_utils import fold_concrete_bytes

        folded_code = fold_concrete_bytes(callee_code)
        if not all(isinstance(b, int) for b in folded_code):
            log.debug("Symbolic creation code; treating result as symbolic")
            mstate.stack.append(
                global_state.new_bitvec(
                    "create_result_" + str(mstate.pc), 256
                )
            )
            return [global_state]

        code_raw = bytes(folded_code)
        code_str = code_raw.hex()
        caller = environment.active_account.address
        gas_price = environment.gasprice
        origin = environment.origin

        contract_address: Optional[int] = None
        if create2_salt is not None:
            if create2_salt.symbolic:
                if create2_salt.size() != 256:
                    pad = symbol_factory.BitVecVal(
                        0, 256 - create2_salt.size()
                    )
                    create2_salt = Concat(pad, create2_salt)
                from ..support.support_utils import sha3

                address = keccak_function_manager.create_keccak(
                    Concat(
                        symbol_factory.BitVecVal(255, 8),
                        Extract(159, 0, caller),
                        create2_salt,
                        symbol_factory.BitVecVal(
                            int.from_bytes(sha3(code_raw), "big"), 256
                        ),
                    )
                )
                contract_address_bv = Extract(255, 96, address)
                mstate.stack.append(
                    Concat(
                        symbol_factory.BitVecVal(0, 96),
                        contract_address_bv,
                    )
                )
                return [global_state]
            from ..support.support_utils import sha3

            salt_bytes = create2_salt.value.to_bytes(32, "big")
            caller_bytes = caller.value.to_bytes(20, "big") \
                if caller.value is not None else b"\x00" * 20
            address_digest = sha3(
                b"\xff" + caller_bytes + salt_bytes + sha3(code_raw)
            )
            contract_address = int.from_bytes(address_digest[12:], "big")

        transaction = ContractCreationTransaction(
            world_state=world_state,
            caller=caller,
            code=_make_disassembly(code_str),
            call_data=None,
            gas_price=gas_price,
            gas_limit=mstate.gas_limit,
            origin=origin,
            call_value=call_value,
            contract_address=contract_address,
        )
        raise TransactionStartSignal(
            transaction, self.op_code, global_state
        )

    @StateTransition(is_state_mutation_instruction=True)
    def create_(self, global_state: GlobalState) -> List[GlobalState]:
        call_value, mem_offset, mem_size = global_state.mstate.pop(3)
        return self._create_transaction_helper(
            global_state, call_value, mem_offset, mem_size
        )

    @StateTransition()
    def create_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._handle_create_type_post(global_state)

    @StateTransition(is_state_mutation_instruction=True)
    def create2_(self, global_state: GlobalState) -> List[GlobalState]:
        call_value, mem_offset, mem_size, salt = global_state.mstate.pop(4)
        return self._create_transaction_helper(
            global_state, call_value, mem_offset, mem_size, salt
        )

    @StateTransition()
    def create2_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self._handle_create_type_post(global_state, opcode="create2")

    @staticmethod
    def _handle_create_type_post(global_state, opcode="create"):
        if opcode == "create2":
            global_state.mstate.pop(4)
        else:
            global_state.mstate.pop(3)
        if global_state.last_return_data:
            return_val = symbol_factory.BitVecVal(
                int(global_state.last_return_data.return_data, 16), 256
            )
        else:
            return_val = symbol_factory.BitVecVal(0, 256)
        global_state.mstate.stack.append(return_val)
        return [global_state]

    # -- return / halt family ----------------------------------------------

    @StateTransition(increment_pc=False)
    def return_(self, global_state: GlobalState):
        state = global_state.mstate
        offset, length = state.stack.pop(), state.stack.pop()
        if length.value is None:
            # symbolic length: model return data as fresh symbols
            return_data = [
                global_state.new_bitvec(
                    "return_data_byte_" + str(i), 8
                )
                for i in range(32)
            ]
            global_state.current_transaction.end(
                global_state,
                return_data=ReturnData(return_data, length),
            )
        state.mem_extend(offset, length.value)
        StateTransition(increment_pc=False).check_gas_usage_limit(
            global_state
        )
        return_data = [
            state.memory[offset + i] for i in range(length.value)
        ]
        global_state.current_transaction.end(
            global_state,
            return_data=ReturnData(return_data, length),
        )

    @StateTransition(increment_pc=False)
    def stop_(self, global_state: GlobalState):
        global_state.current_transaction.end(
            global_state, return_data=None
        )

    @StateTransition(increment_pc=False)
    def revert_(self, global_state: GlobalState):
        state = global_state.mstate
        offset, length = state.stack.pop(), state.stack.pop()
        try:
            return_data = [
                state.memory[offset + i]
                for i in range(util.get_concrete_int(length))
            ]
            return_data_obj = ReturnData(return_data, length)
        except TypeError:
            return_data_obj = ReturnData(
                [global_state.new_bitvec("return_data", 8)], length
            )
        global_state.current_transaction.end(
            global_state, return_data=return_data_obj, revert=True
        )

    @StateTransition(increment_pc=False,
                     is_state_mutation_instruction=True)
    def selfdestruct_(self, global_state: GlobalState):
        target = global_state.mstate.stack.pop()
        transfer_amount = (
            global_state.environment.active_account.balance()
        )
        # often the target of the suicide; transfer the balance there
        global_state.world_state.balances[target] += transfer_amount
        global_state.environment.active_account = deepcopy(
            global_state.environment.active_account
        )
        global_state.world_state.put_account(
            global_state.environment.active_account
        )
        global_state.environment.active_account.set_balance(0)
        global_state.environment.active_account.deleted = True
        global_state.current_transaction.end(global_state)

    @StateTransition(increment_pc=False, enable_gas=False)
    def invalid_(self, global_state: GlobalState):
        raise InvalidInstruction

    @StateTransition()
    def assert_fail_(self, global_state: GlobalState):
        # aliases invalid_ for the old Solidity assert encoding
        raise InvalidInstruction

    # -- CALL family --------------------------------------------------------

    @StateTransition(increment_pc=False)
    def call_(self, global_state: GlobalState) -> List[GlobalState]:
        environment = global_state.environment
        # capture the out-window BEFORE get_call_parameters pops the 7
        # args: the ValueError path below must not touch the popped stack
        # (reference instructions.py reads stack[-7:-5] up front)
        out_offset_pre = global_state.mstate.stack[-6]
        out_size_pre = global_state.mstate.stack[-7]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(
                global_state, self.dynamic_loader, True
            )
            if callee_account is not None and (
                callee_account.code.bytecode == ""
                or callee_account.code.bytecode == "0x"
            ):
                # the callee is empty: just transfer value, push an
                # unconstrained success flag
                log.debug("The call is related to ether transfer between "
                          "accounts")
                sender = environment.active_account.address
                receiver = callee_account.address
                transfer_ether(global_state, sender, receiver, value)
                global_state.mstate.min_gas_used += (
                    get_opcode_gas("CALL")[0]
                )
                global_state.mstate.max_gas_used += (
                    get_opcode_gas("CALL")[1]
                )
                self._write_symbolic_returndata(
                    global_state, memory_out_offset, memory_out_size
                )
                util.push_unconstrained_ret_val(global_state)
                global_state.mstate.pc += 1
                return [global_state]
        except ValueError as e:
            log.debug(
                "Could not determine required parameters for call: %s", e
            )
            # get_call_parameters pops its 7 args before it can raise
            self._write_symbolic_returndata(
                global_state, out_offset_pre, out_size_pre
            )
            util.push_unconstrained_ret_val(global_state)
            global_state.mstate.pc += 1
            return [global_state]

        native_result = native_call(
            global_state,
            callee_address,
            call_data,
            memory_out_offset,
            memory_out_size,
        )
        if native_result:
            for state in native_result:
                state.mstate.pc += 1
            return native_result

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            caller=environment.active_account.address,
            callee_account=callee_account,
            call_data=call_data,
            call_value=value,
            static=environment.static,
        )
        raise TransactionStartSignal(
            transaction, self.op_code, global_state
        )

    @StateTransition()
    def call_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="call")

    @StateTransition(increment_pc=False)
    def callcode_(self, global_state: GlobalState) -> List[GlobalState]:
        environment = global_state.environment
        out_offset_pre = global_state.mstate.stack[-6]
        out_size_pre = global_state.mstate.stack[-7]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(
                global_state, self.dynamic_loader, True
            )
            if callee_account is not None and (
                callee_account.code.bytecode == ""
                or callee_account.code.bytecode == "0x"
            ):
                log.debug("The call is related to ether transfer between "
                          "accounts")
                sender = global_state.environment.active_account.address
                receiver = callee_account.address
                transfer_ether(global_state, sender, receiver, value)
                self._write_symbolic_returndata(
                    global_state, memory_out_offset, memory_out_size
                )
                util.push_unconstrained_ret_val(global_state)
                global_state.mstate.pc += 1
                return [global_state]
        except ValueError as e:
            log.debug(
                "Could not determine required parameters for call: %s", e
            )
            # get_call_parameters pops its 7 args before it can raise
            self._write_symbolic_returndata(
                global_state, out_offset_pre, out_size_pre
            )
            util.push_unconstrained_ret_val(global_state)
            global_state.mstate.pc += 1
            return [global_state]

        native_result = native_call(
            global_state,
            callee_address,
            call_data,
            memory_out_offset,
            memory_out_size,
        )
        if native_result:
            for state in native_result:
                state.mstate.pc += 1
            return native_result

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code if callee_account else None,
            caller=environment.address,
            callee_account=environment.active_account,
            call_data=call_data,
            call_value=value,
            static=environment.static,
        )
        raise TransactionStartSignal(
            transaction, self.op_code, global_state
        )

    @StateTransition()
    def callcode_post(self, global_state: GlobalState) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="callcode")

    @StateTransition(increment_pc=False)
    def delegatecall_(self, global_state: GlobalState) -> List[GlobalState]:
        environment = global_state.environment
        out_offset_pre = global_state.mstate.stack[-5]
        out_size_pre = global_state.mstate.stack[-6]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                _,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(global_state, self.dynamic_loader)
            if callee_account is not None and (
                callee_account.code.bytecode == ""
                or callee_account.code.bytecode == "0x"
            ):
                log.debug("The call is related to ether transfer between "
                          "accounts")
                self._write_symbolic_returndata(
                    global_state, memory_out_offset, memory_out_size
                )
                util.push_unconstrained_ret_val(global_state)
                global_state.mstate.pc += 1
                return [global_state]
        except ValueError as e:
            log.debug(
                "Could not determine required parameters for call: %s", e
            )
            # get_call_parameters pops its 6 args before it can raise
            self._write_symbolic_returndata(
                global_state, out_offset_pre, out_size_pre
            )
            util.push_unconstrained_ret_val(global_state)
            global_state.mstate.pc += 1
            return [global_state]

        native_result = native_call(
            global_state,
            callee_address,
            call_data,
            memory_out_offset,
            memory_out_size,
        )
        if native_result:
            for state in native_result:
                state.mstate.pc += 1
            return native_result

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code if callee_account else None,
            caller=environment.sender,
            callee_account=environment.active_account,
            call_data=call_data,
            call_value=environment.callvalue,
            static=environment.static,
        )
        raise TransactionStartSignal(
            transaction, self.op_code, global_state
        )

    @StateTransition()
    def delegatecall_post(self, global_state: GlobalState
                          ) -> List[GlobalState]:
        return self.post_handler(
            global_state, function_name="delegatecall"
        )

    @StateTransition(increment_pc=False)
    def staticcall_(self, global_state: GlobalState) -> List[GlobalState]:
        environment = global_state.environment
        out_offset_pre = global_state.mstate.stack[-5]
        out_size_pre = global_state.mstate.stack[-6]
        try:
            (
                callee_address,
                callee_account,
                call_data,
                value,
                gas,
                memory_out_offset,
                memory_out_size,
            ) = get_call_parameters(global_state, self.dynamic_loader)
            if callee_account is not None and (
                callee_account.code.bytecode == ""
                or callee_account.code.bytecode == "0x"
            ):
                log.debug("The call is related to ether transfer between "
                          "accounts")
                self._write_symbolic_returndata(
                    global_state, memory_out_offset, memory_out_size
                )
                util.push_unconstrained_ret_val(global_state)
                global_state.mstate.pc += 1
                return [global_state]
        except ValueError as e:
            log.debug(
                "Could not determine required parameters for call: %s", e
            )
            # get_call_parameters pops its 6 args before it can raise
            self._write_symbolic_returndata(
                global_state, out_offset_pre, out_size_pre
            )
            util.push_unconstrained_ret_val(global_state)
            global_state.mstate.pc += 1
            return [global_state]

        native_result = native_call(
            global_state,
            callee_address,
            call_data,
            memory_out_offset,
            memory_out_size,
        )
        if native_result:
            for state in native_result:
                state.mstate.pc += 1
            return native_result

        transaction = MessageCallTransaction(
            world_state=global_state.world_state,
            gas_price=environment.gasprice,
            gas_limit=gas,
            origin=environment.origin,
            code=callee_account.code if callee_account else None,
            caller=environment.address,
            callee_account=callee_account,
            call_data=call_data,
            call_value=value,
            static=True,
        )
        raise TransactionStartSignal(
            transaction, self.op_code, global_state
        )

    @StateTransition()
    def staticcall_post(self, global_state: GlobalState
                        ) -> List[GlobalState]:
        return self.post_handler(global_state, function_name="staticcall")

    def post_handler(self, global_state,
                     function_name: str) -> List[GlobalState]:
        """Resume the caller after a sub-call: write return data into
        caller memory and push the success flag."""
        if function_name in ("staticcall", "delegatecall"):
            out_offset = global_state.mstate.stack[-5]
            out_size = global_state.mstate.stack[-6]
            num_pops = 6
        else:
            out_offset = global_state.mstate.stack[-6]
            out_size = global_state.mstate.stack[-7]
            num_pops = 7
        for _ in range(num_pops):
            global_state.mstate.stack.pop()

        if global_state.last_return_data is None:
            # the sub-call reverted or returned nothing usable
            self._write_symbolic_returndata(
                global_state, out_offset, out_size
            )
            util.push_unconstrained_ret_val(global_state)
            return [global_state]

        try:
            memory_out_offset = util.get_concrete_int(out_offset)
            memory_out_size = util.get_concrete_int(out_size)
        except TypeError:
            util.push_unconstrained_ret_val(global_state)
            return [global_state]

        # write return data to memory
        for i in range(
            min(
                memory_out_size,
                len(global_state.last_return_data.return_data),
            )
        ):
            global_state.mstate.memory[memory_out_offset + i] = (
                global_state.last_return_data.return_data[i]
            )

        # return value + constraint
        return_value = global_state.new_bitvec(
            "retval_" + str(
                global_state.get_current_instruction()["address"]
            ),
            256,
        )
        global_state.mstate.stack.append(return_value)
        global_state.world_state.constraints.append(return_value == 1)
        return [global_state]

    @staticmethod
    def _write_symbolic_returndata(global_state: GlobalState,
                                   memory_out_offset,
                                   memory_out_size):
        """Fill the output window with fresh symbols when actual return
        data is unavailable."""
        if isinstance(memory_out_offset, Expression):
            if memory_out_offset.symbolic:
                return
            memory_out_offset = memory_out_offset.value
        if isinstance(memory_out_size, Expression):
            if memory_out_size.symbolic:
                return
            memory_out_size = memory_out_size.value
        for i in range(min(memory_out_size, SYMBOLIC_CALLDATA_SIZE)):
            global_state.mstate.memory[
                memory_out_offset + i
            ] = global_state.new_bitvec(
                "call_output_var({})_{}".format(
                    simplify(
                        symbol_factory.BitVecVal(memory_out_offset, 256)
                        + i
                    ),
                    global_state.mstate.pc,
                ),
                8,
            )


def _make_disassembly(code_str: str):
    from ..disassembler.disassembly import Disassembly

    return Disassembly(code_str)
