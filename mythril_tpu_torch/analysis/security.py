"""Detector orchestration (capability parity:
mythril/analysis/security.py:14-45)."""

import logging
from typing import List, Optional

from .module.base import EntryPoint
from .module.loader import ModuleLoader
from .module.util import get_detection_module_hooks, reset_callback_modules
from .report import Issue

log = logging.getLogger(__name__)


def retrieve_callback_issues(white_list: Optional[List[str]] = None
                             ) -> List[Issue]:
    """Collect issues from callback detection modules."""
    issues: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.CALLBACK, white_list=white_list
    ):
        log.debug("Retrieving results for %s", module.name)
        issues += module.issues
    reset_callback_modules(module_names=white_list)
    return issues


def fire_lasers(statespace, white_list: Optional[List[str]] = None
                ) -> List[Issue]:
    """Run POST modules over the statespace, then collect callback-module
    issues."""
    log.info("Starting analysis")
    issues: List[Issue] = []
    for module in ModuleLoader().get_detection_modules(
        entry_point=EntryPoint.POST, white_list=white_list
    ):
        log.info("Executing %s", module.name)
        issues += module.execute(statespace)
    issues += retrieve_callback_issues(white_list)
    return issues
