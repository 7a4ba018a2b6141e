"""Function-signature database (capability parity:
mythril/support/signatures.py:117-280).

SQLite-backed selector -> text-signature store at ~/.mythril_tpu_torch/
signatures.db. Instead of shipping a binary seed asset, the DB is seeded at
first use by hashing a bundled list of common Solidity signatures with the
native keccak (same observable behavior: common selectors resolve to names,
unknown selectors fall back to `_function_0x...`). Online 4byte.directory
lookup is supported behind a flag but disabled by default (no egress in this
environment)."""

import logging
import os
import sqlite3
import threading
from typing import List

log = logging.getLogger(__name__)

COMMON_SIGNATURES = [
    "transfer(address,uint256)",
    "transferFrom(address,address,uint256)",
    "approve(address,uint256)",
    "balanceOf(address)",
    "allowance(address,address)",
    "totalSupply()",
    "mint(address,uint256)",
    "burn(uint256)",
    "owner()",
    "transferOwnership(address)",
    "renounceOwnership()",
    "withdraw()",
    "withdraw(uint256)",
    "deposit()",
    "deposit(uint256)",
    "kill()",
    "killcontract()",
    "destroy()",
    "selfdestruct(address)",
    "fallback()",
    "name()",
    "symbol()",
    "decimals()",
    "pause()",
    "unpause()",
    "setOwner(address)",
    "getBalance()",
    "getBalance(address)",
    "sendTo(address,uint256)",
    "claim()",
    "claimOwnership()",
    "initialize()",
    "initWallet(address[],uint256,uint256)",
    "execute(address,uint256,bytes)",
    "confirm(bytes32)",
    "isOwner(address)",
    "changeOwner(address)",
    "acceptOwnership()",
    "setPrice(uint256)",
    "buy()",
    "sell(uint256)",
    "batchTransfer(address[],uint256)",
    "collectAllocations()",
    "payOut()",
    "sendPayment()",
    "withdrawfunds()",
    "invest()",
    "setAllocation(address,uint256)",
    "getTokens()",
    "play()",
    "play(uint256)",
    "bet()",
    "random()",
]


class SignatureDB(object, metaclass=type):
    _instance = None
    _lock = threading.Lock()

    def __new__(cls, *args, **kwargs):
        with cls._lock:
            if cls._instance is None:
                cls._instance = super().__new__(cls)
                cls._instance._initialized = False
        return cls._instance

    def __init__(self, enable_online_lookup: bool = False, path: str = None):
        if self._initialized:
            return
        self._initialized = True
        self.enable_online_lookup = enable_online_lookup
        self.path = path or os.path.join(
            os.environ.get(
                "MYTHRIL_DIR", os.path.join(os.path.expanduser("~"),
                                            ".mythril_tpu_torch")
            ),
            "signatures.db",
        )
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.conn = sqlite3.connect(self.path, check_same_thread=False)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS signatures"
            " (byte_sig VARCHAR(10), text_sig VARCHAR(255),"
            " PRIMARY KEY (byte_sig, text_sig))"
        )
        self._seed()

    #: bump when the seed contents change so existing databases pick
    #: up the new pack (rows are INSERT OR IGNORE — re-seeding is safe)
    SEED_VERSION = 2

    def _seed(self) -> None:
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS seed_meta (version INTEGER)"
        )
        cur = self.conn.execute("SELECT MAX(version) FROM seed_meta")
        row = cur.fetchone()
        if row and row[0] is not None and row[0] >= self.SEED_VERSION:
            return
        from .support_utils import sha3

        rows = []
        for sig in COMMON_SIGNATURES:
            selector = "0x" + sha3(sig.encode())[:4].hex()
            rows.append((selector, sig))
        # generated offline seed pack (tools/gen_signatures.py) — the
        # counterpart of the reference's shipped signatures.db asset
        # (mythril/mythril/mythril_config.py:52-58): lets offline runs
        # resolve real function names instead of _function_0x… stubs
        asset = os.path.join(
            os.path.dirname(os.path.abspath(__file__)),
            "assets", "signatures.txt",
        )
        try:
            with open(asset) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2 and parts[0].startswith("0x"):
                        rows.append((parts[0].lower(), parts[1]))
        except OSError:
            log.debug("no signature seed pack at %s", asset)
        self.conn.executemany(
            "INSERT OR IGNORE INTO signatures VALUES (?, ?)", rows
        )
        self.conn.execute("DELETE FROM seed_meta")
        self.conn.execute("INSERT INTO seed_meta VALUES (?)",
                          (self.SEED_VERSION,))
        self.conn.commit()

    def get(self, byte_sig: str) -> List[str]:
        """Text signatures for a 4-byte selector hex string."""
        byte_sig = byte_sig.lower()
        cur = self.conn.execute(
            "SELECT text_sig FROM signatures WHERE byte_sig = ?", (byte_sig,)
        )
        return [r[0] for r in cur.fetchall()]

    def __getitem__(self, item: str) -> List[str]:
        return self.get(item)

    def add(self, byte_sig: str, text_sig: str) -> None:
        self.conn.execute(
            "INSERT OR IGNORE INTO signatures VALUES (?, ?)",
            (byte_sig.lower(), text_sig),
        )
        self.conn.commit()

    def import_solidity_abi(self, abi) -> None:
        """Import function signatures from a compiled contract's ABI."""
        from .support_utils import sha3

        for entry in abi or []:
            if entry.get("type") != "function":
                continue
            sig = "{}({})".format(
                entry.get("name", ""),
                ",".join(i.get("type", "") for i in entry.get("inputs", [])),
            )
            self.add("0x" + sha3(sig.encode())[:4].hex(), sig)

    def import_solidity_file(self, file_path: str,
                             solc_binary: str = "solc",
                             solc_settings_json: str = None) -> None:
        """Import signatures from a solidity source via solc --hashes."""
        import subprocess

        try:
            output = subprocess.check_output(
                [solc_binary, "--hashes", file_path], text=True
            )
        except (OSError, subprocess.CalledProcessError) as e:
            log.debug("solc signature import failed: %s", e)
            return
        for line in output.splitlines():
            parts = line.strip().split(": ")
            if len(parts) == 2 and len(parts[0]) == 8:
                self.add("0x" + parts[0], parts[1])

    @staticmethod
    def lookup_online(byte_sig: str, timeout: int = 2) -> List[str]:
        """4byte.directory lookup; returns [] without network access."""
        import json
        import urllib.request

        try:
            url = (
                "https://www.4byte.directory/api/v1/signatures/?hex_signature="
                + byte_sig
            )
            with urllib.request.urlopen(url, timeout=timeout) as resp:
                data = json.load(resp)
            return [r["text_signature"] for r in data.get("results", [])]
        except Exception:
            return []
