"""Detection-module interface (capability parity:
mythril/analysis/module/base.py:20-118)."""

import logging
from abc import ABC, abstractmethod
from enum import Enum
from typing import List, Optional, Set, Tuple

from ...laser.state.global_state import GlobalState
from ...support.support_args import args
from ...support.support_utils import get_code_hash
from ..report import Issue

log = logging.getLogger(__name__)


class EntryPoint(Enum):
    """POST modules scan the finished statespace; CALLBACK modules hook
    opcodes during execution (preferred)."""

    POST = 1
    CALLBACK = 2


class DetectionModule(ABC):
    """Base class for all detection modules.

    Class attributes expose the module's metadata: name, swc_id,
    description, entry_point, and the pre/post instruction hooks it
    requests."""

    name = "Detection Module Name / Title"
    swc_id = "SWC-000"
    description = "Detection module description"
    entry_point: EntryPoint = EntryPoint.CALLBACK
    pre_hooks: List[str] = []
    post_hooks: List[str] = []

    def __init__(self) -> None:
        self.issues: List[Issue] = []
        self.cache: Set[Tuple[int, str]] = set()
        self.auto_cache = True

    def reset_module(self):
        self.issues = []

    def update_cache(self, issues=None):
        """Record (address, code-hash) pairs of found issues so the same
        site isn't re-analyzed."""
        issues = issues or self.issues
        for issue in issues:
            self.cache.add((issue.address, issue.bytecode_hash))

    def execute(self, target: GlobalState) -> Optional[List[Issue]]:
        """Hook entry point called by the VM."""
        log.debug(
            "Entering analysis module: %s", self.__class__.__name__
        )
        if (
            self.auto_cache
            and (
                target.get_current_instruction()["address"],
                get_code_hash(target.environment.code.bytecode),
            )
            in self.cache
        ):
            log.debug(
                "Issue in cache for %s at %s",
                self.__class__.__name__,
                target.get_current_instruction()["address"],
            )
            return []
        result = self._execute(target)
        log.debug("Exiting analysis module: %s", self.__class__.__name__)
        if result and not args.use_issue_annotations:
            if self.auto_cache:
                self.update_cache(result)
            self.issues += result
        return result

    @abstractmethod
    def _execute(self, target) -> Optional[List[Issue]]:
        """Module main method (override this)."""

    def __repr__(self) -> str:
        return (
            "<DetectionModule name={0.name} swc_id={0.swc_id} "
            "pre_hooks={0.pre_hooks} post_hooks={0.post_hooks} "
            "description={0.description}>"
        ).format(self)
