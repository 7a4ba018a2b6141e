"""Minimal Ethereum JSON-RPC client (capability parity:
mythril/ethereum/interface/rpc/client.py:1-88 — eth_getCode,
eth_getBalance, eth_getStorageAt, eth_getTransactionByHash, plus the raw
call plumbing). Uses only the standard library (urllib); no egress happens
unless the user explicitly points an analysis at a node with
--rpc/--infura-id."""

import json
import logging
import urllib.request
from typing import Any, List, Optional

log = logging.getLogger(__name__)

JSON_MEDIA_TYPE = "application/json"
JSON_RPC_VERSION = "2.0"
BLOCK_TAGS = ("earliest", "latest", "pending")


class EthJsonRpcError(Exception):
    """Base RPC failure."""


class ConnectionError_(EthJsonRpcError):
    """Could not reach the node."""


class BadStatusCodeError(EthJsonRpcError):
    pass


class BadJsonError(EthJsonRpcError):
    pass


class BadResponseError(EthJsonRpcError):
    pass


def _validate_block(block) -> str:
    if isinstance(block, str):
        if block not in BLOCK_TAGS:
            raise ValueError(f"invalid block tag: {block}")
        return block
    if isinstance(block, int):
        return hex(block)
    raise ValueError(f"invalid block: {block!r}")


def _hex(n: int) -> str:
    return hex(n)


class BaseClient:
    def eth_getCode(self, address: str, default_block="latest") -> str:
        raise NotImplementedError

    def eth_getBalance(self, address: str, default_block="latest") -> int:
        raise NotImplementedError

    def eth_getStorageAt(
        self, address: str, position: int = 0, default_block="latest"
    ) -> str:
        raise NotImplementedError


class EthJsonRpc(BaseClient):
    """Plain HTTP(S) JSON-RPC transport + typed eth_* helpers."""

    def __init__(self, host: str = "localhost", port: int = 8545,
                 tls: bool = False, timeout: float = 10.0):
        self.host = host
        self.port = port
        self.tls = tls
        self.timeout = timeout
        self._id = 0

    @property
    def endpoint(self) -> str:
        scheme = "https" if self.tls else "http"
        host = self.host
        if host.startswith(("http://", "https://")):
            return host  # full URL supplied (e.g. infura)
        return f"{scheme}://{host}:{self.port}"

    def _call(self, method: str, params: Optional[List[Any]] = None) -> Any:
        self._id += 1
        payload = {
            "jsonrpc": JSON_RPC_VERSION,
            "method": method,
            "params": params or [],
            "id": self._id,
        }
        req = urllib.request.Request(
            self.endpoint,
            data=json.dumps(payload).encode(),
            headers={"Content-Type": JSON_MEDIA_TYPE},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                if resp.status != 200:
                    raise BadStatusCodeError(resp.status)
                body = resp.read()
        except OSError as e:
            raise ConnectionError_(str(e)) from e
        try:
            parsed = json.loads(body)
        except ValueError as e:
            raise BadJsonError(str(e)) from e
        if "result" not in parsed:
            raise BadResponseError(parsed.get("error"))
        return parsed["result"]

    # -- typed helpers ------------------------------------------------------

    def eth_getCode(self, address: str, default_block="latest") -> str:
        return self._call(
            "eth_getCode", [address, _validate_block(default_block)]
        )

    def eth_getBalance(self, address: str, default_block="latest") -> int:
        out = self._call(
            "eth_getBalance", [address, _validate_block(default_block)]
        )
        return int(out, 16)

    def eth_getStorageAt(
        self, address: str, position: int = 0, default_block="latest"
    ) -> str:
        return self._call(
            "eth_getStorageAt",
            [address, _hex(position), _validate_block(default_block)],
        )

    def eth_getTransactionByHash(self, tx_hash: str):
        return self._call("eth_getTransactionByHash", [tx_hash])

    def eth_getBlockByNumber(self, block: int, full: bool = True):
        return self._call(
            "eth_getBlockByNumber", [_validate_block(block), full]
        )

    def eth_blockNumber(self) -> int:
        return int(self._call("eth_blockNumber"), 16)

    def web3_clientVersion(self) -> str:
        return self._call("web3_clientVersion")
