"""EVM contract container (capability parity:
mythril/ethereum/evmcontract.py:14-119)."""

import logging
import re
from typing import Dict, List

from ..disassembler.disassembly import Disassembly
from ..support.support_utils import get_code_hash

log = logging.getLogger(__name__)


class EVMContract:
    """Holds runtime and creation bytecode plus metadata."""

    def __init__(self, code="", creation_code="", name="Unknown",
                 enable_online_lookup=False):
        self.creation_code = creation_code
        self.name = name
        self.code = code
        self.enable_online_lookup = enable_online_lookup

        if not self.code and self.creation_code:
            # heuristic runtime extraction: the deployed code usually
            # follows the last CODECOPY/RETURN prologue; keep creation-only
            # analysis possible regardless
            log.debug("no runtime code provided; creation-only analysis")

        self._disassembly = None
        self._creation_disassembly = None

    @property
    def bytecode_hash(self) -> str:
        return get_code_hash(self.code)

    @property
    def creation_bytecode_hash(self) -> str:
        return get_code_hash(self.creation_code)

    def as_dict(self) -> Dict:
        return {
            "name": self.name,
            "code": self.code,
            "creation_code": self.creation_code,
            "disassembly": self.disassembly,
        }

    @property
    def disassembly(self) -> Disassembly:
        if self._disassembly is None:
            self._disassembly = Disassembly(
                self.code, enable_online_lookup=self.enable_online_lookup
            )
        return self._disassembly

    @property
    def creation_disassembly(self) -> Disassembly:
        if self._creation_disassembly is None:
            self._creation_disassembly = Disassembly(
                self.creation_code,
                enable_online_lookup=self.enable_online_lookup,
            )
        return self._creation_disassembly

    def get_easm(self) -> str:
        return self.disassembly.get_easm()

    def get_creation_easm(self) -> str:
        return self.creation_disassembly.get_easm()

    def matches_expression(self, expression: str) -> bool:
        """Evaluate a search expression like `code#PUSH1#` or
        `func#withdraw()#` against this contract (reference
        evmcontract.py:60-90)."""
        str_eval = ""
        easm_code = None
        tokens = re.split(r"\s+(and|or)\s+", expression, re.IGNORECASE)
        for token in tokens:
            if token in ("and", "or"):
                str_eval += " " + token + " "
                continue
            m = re.match(r"^code#([a-zA-Z0-9\s,\[\]]+)#", token)
            if m:
                if easm_code is None:
                    easm_code = self.get_easm()
                code = m.group(1).replace(",", "\\n")
                str_eval += '"' + code + '" in easm_code'
                continue
            m = re.match(r"^func#([a-zA-Z0-9\s_,(\\)\[\]]+)#$", token)
            if m:
                sign_hash = "0x" + _func_hash(m.group(1))
                str_eval += (
                    '"'
                    + sign_hash
                    + '" in self.disassembly.func_hashes'
                )
                continue
        return eval(str_eval.strip())


def _func_hash(sig: str) -> str:
    from ..support.support_utils import sha3

    return sha3(sig.encode()).hex()[:8]
