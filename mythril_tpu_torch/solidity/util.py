"""solc invocation helpers (capability parity: mythril/ethereum/util.py —
get_solc_json standard-JSON compilation with --allow-paths, solc binary
selection via pragma/--solv, extract_binary). The solc binary is invoked
as a subprocess exactly like the reference; when no solc exists in the
image the caller gets a clear SolcError instead of a crash."""

import json
import logging
import os
import re
import shutil
import subprocess
from subprocess import PIPE
from typing import Optional

log = logging.getLogger(__name__)


class SolcError(Exception):
    pass


def solc_exists(version: Optional[str] = None) -> Optional[str]:
    """Path of a usable solc binary: an exact-version install under
    ~/.solc-select or ~/.py-solc-x if present, else the system solc."""
    home = os.path.expanduser("~")
    candidates = []
    if version:
        candidates += [
            os.path.join(home, ".solc-select", "artifacts",
                         f"solc-{version}", f"solc-{version}"),
            os.path.join(home, ".solcx", f"solc-v{version}"),
        ]
    sys_solc = shutil.which("solc")
    if sys_solc:
        candidates.append(sys_solc)
    for c in candidates:
        if c and os.path.exists(c):
            return c
    return None


def parse_pragma(source: str) -> Optional[str]:
    """First `pragma solidity` version constraint's base version, if the
    constraint pins one (^0.8.19, =0.8.19, 0.8.19)."""
    m = re.search(r"pragma\s+solidity\s+[\^=]?\s*(\d+\.\d+\.\d+)", source)
    return m.group(1) if m else None


def get_solc_json(file: str, solc_binary: str = "solc",
                  solc_settings_json: Optional[str] = None,
                  solc_args: Optional[str] = None) -> dict:
    """Compile `file` with solc --standard-json; returns the parsed output
    with bytecode, deployedBytecode, srcmaps and AST for every contract."""
    settings = {}
    if solc_settings_json:
        if os.path.isfile(solc_settings_json):
            with open(solc_settings_json) as f:
                settings = json.load(f).get("settings", {})
        else:
            settings = json.loads(solc_settings_json).get("settings", {})
    settings.setdefault("outputSelection", {
        "*": {
            "*": [
                "evm.bytecode.object", "evm.bytecode.sourceMap",
                "evm.deployedBytecode.object",
                "evm.deployedBytecode.sourceMap", "abi",
            ],
            "": ["ast"],
        }
    })
    settings.setdefault("optimizer", {"enabled": False})

    standard_input = {
        "language": "Solidity",
        "sources": {file: {"urls": [file]}},
        "settings": settings,
    }
    cmd = [solc_binary, "--standard-json",
           "--allow-paths", os.path.dirname(os.path.abspath(file)) or "."]
    if solc_args:
        cmd.extend(solc_args.split())
    try:
        proc = subprocess.run(
            cmd, input=json.dumps(standard_input).encode(),
            stdout=PIPE, stderr=PIPE, check=False,
        )
    except FileNotFoundError as e:
        raise SolcError(
            f"solc binary '{solc_binary}' not found — install solc or "
            f"pass --bin-runtime bytecode directly"
        ) from e
    try:
        out = json.loads(proc.stdout)
    except ValueError as e:
        raise SolcError(
            f"solc produced invalid JSON (stderr: "
            f"{proc.stderr.decode()[:400]})"
        ) from e
    errors = [
        e for e in out.get("errors", []) if e.get("severity") == "error"
    ]
    if errors:
        raise SolcError(
            "\n".join(e.get("formattedMessage", str(e)) for e in errors)
        )
    return out


def extract_binary(file: str) -> bytes:
    """Read a .sol.o / hex bytecode file into bytes."""
    with open(file) as f:
        code = f.read().strip()
    if code.startswith("0x"):
        code = code[2:]
    return bytes.fromhex(code)
