"""Runtime configuration (capability parity:
mythril/mythril/mythril_config.py:18-222 — ~/.mythril dir bootstrap,
config.ini parsing, RPC endpoint selection including Infura-backed L2
networks, MYTHRIL_DIR/INFURA_ID env overrides)."""

import configparser
import logging
import os
from pathlib import Path
from typing import Optional

from ..ethereum.rpc.client import EthJsonRpc

log = logging.getLogger(__name__)

CONFIG_FILE = "config.ini"

INFURA_NETWORKS = {
    "mainnet": "https://mainnet.infura.io/v3/{}",
    "goerli": "https://goerli.infura.io/v3/{}",
    "sepolia": "https://sepolia.infura.io/v3/{}",
    "arbitrum": "https://arbitrum-mainnet.infura.io/v3/{}",
    "avalanche": "https://avalanche-mainnet.infura.io/v3/{}",
    "optimism": "https://optimism-mainnet.infura.io/v3/{}",
    "polygon": "https://polygon-mainnet.infura.io/v3/{}",
}


class MythrilConfig:
    def __init__(self):
        self.infura_id: Optional[str] = os.getenv("INFURA_ID")
        self.mythril_dir = self._init_mythril_dir()
        self.config_path = os.path.join(self.mythril_dir, CONFIG_FILE)
        self.eth: Optional[EthJsonRpc] = None
        self._init_config()

    @staticmethod
    def _init_mythril_dir() -> str:
        """~/.mythril_tpu_torch (or MYTHRIL_DIR), created on first use."""
        mythril_dir = os.environ.get(
            "MYTHRIL_DIR", os.path.join(str(Path.home()), ".mythril_tpu_torch")
        )
        os.makedirs(mythril_dir, exist_ok=True)
        return mythril_dir

    def _init_config(self) -> None:
        """Create/load config.ini; pick up a default RPC + infura id."""
        config = configparser.ConfigParser()
        if os.path.exists(self.config_path):
            try:
                config.read(self.config_path)
            except configparser.Error as e:
                log.warning("corrupt config.ini ignored: %s", e)
        if "defaults" not in config:
            config["defaults"] = {
                "dynamic_loading": "infura",
            }
            try:
                from ..support.lock import LockFile

                # temp-file + atomic rename: a concurrent or interrupted
                # writer can never leave a half-written config.ini for
                # readers (which run unlocked)
                with LockFile(self.config_path + ".lock"):
                    tmp = self.config_path + ".tmp"
                    with open(tmp, "w") as f:
                        config.write(f)
                    os.replace(tmp, self.config_path)
            except OSError as e:
                log.debug("could not write config: %s", e)
        defaults = config["defaults"]
        if self.infura_id is None:
            self.infura_id = defaults.get("infura_id", None)
        self._default_rpc = defaults.get("dynamic_loading", "infura")

    def set_api_infura_id(self, infura_id: str) -> None:
        self.infura_id = infura_id

    def set_api_rpc(self, rpc: Optional[str] = None,
                    rpctls: bool = False) -> None:
        """rpc: 'ganache', 'infura-<net>', or 'host:port'."""
        if rpc == "ganache":
            self.eth = EthJsonRpc("localhost", 8545, rpctls)
            return
        if rpc and rpc.startswith("infura-"):
            network = rpc[len("infura-"):]
            if network not in INFURA_NETWORKS:
                raise ValueError(f"unknown infura network: {network}")
            if not self.infura_id:
                raise ValueError(
                    "an INFURA_ID is required for infura networks"
                )
            url = INFURA_NETWORKS[network].format(self.infura_id)
            self.eth = EthJsonRpc(url, 443, True)
            return
        if rpc:
            host, _, port = rpc.partition(":")
            self.eth = EthJsonRpc(host, int(port) if port else 8545, rpctls)
            return
        self.set_api_rpc("infura-mainnet" if self.infura_id else "ganache")

    def set_api_from_config_path(self) -> None:
        self.set_api_rpc(
            "infura-mainnet"
            if self._default_rpc == "infura" and self.infura_id
            else None if self._default_rpc == "infura" else self._default_rpc
        )
