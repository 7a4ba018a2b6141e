"""Issue and Report classes (capability parity:
mythril/analysis/report.py:23-380 — same issue fields and the four output
formats text/json/jsonv2(SWC)/markdown, rendered with plain string
formatting instead of jinja2 templates)."""

import base64
import hashlib
import json
import logging
import operator
import time
from typing import Any, Dict, List, Optional

from ..laser.execution_info import ExecutionInfo
from ..smt import BitVec
from ..support.signatures import SignatureDB
from ..support.source_support import Source
from ..support.start_time import StartTime
from .swc_data import SWC_TO_TITLE

log = logging.getLogger(__name__)


class Issue:
    """One discovered vulnerability instance."""

    def __init__(
        self,
        contract: str,
        function_name: str,
        address: int,
        swc_id: str,
        title: str,
        bytecode: str,
        gas_used=(None, None),
        severity=None,
        description_head="",
        description_tail="",
        transaction_sequence=None,
        source_location=None,
    ):
        self.title = title
        self.contract = contract
        self.function = function_name
        self.address = address
        self.description_head = description_head
        self.description_tail = description_tail
        self.description = "%s\n%s" % (description_head, description_tail)
        self.severity = severity
        self.swc_id = swc_id
        self.min_gas_used, self.max_gas_used = gas_used
        self.filename = None
        self.code = None
        self.lineno = None
        self.source_mapping = None
        # elapsed since analysis start, like the reference (report.py:69);
        # clamped: the singleton may initialize lazily in this expression
        self.discovery_time = max(
            0.0, time.time() - StartTime().global_start_time
        )
        self.bytecode_hash = get_code_hash(bytecode)
        self.transaction_sequence = transaction_sequence
        self.source_location = source_location

    @property
    def transaction_sequence_users(self):
        """Tx sequence with resolved function names (user view)."""
        return self.transaction_sequence

    @property
    def transaction_sequence_jsonv2(self):
        return self.transaction_sequence

    @property
    def as_dict(self) -> Dict[str, Any]:
        issue = {
            "title": self.title,
            "swc-id": self.swc_id,
            "contract": self.contract,
            "description": self.description,
            "function": self.function,
            "severity": self.severity,
            "address": self.address,
            "tx_sequence": self.transaction_sequence,
            "min_gas_used": self.min_gas_used,
            "max_gas_used": self.max_gas_used,
            "sourceMap": self.source_mapping,
        }
        if self.filename and self.lineno:
            issue["filename"] = self.filename
            issue["lineno"] = self.lineno
        if self.code:
            issue["code"] = self.code
        return issue

    def _set_internal_compiler_error(self):
        self.filename = "Internal Compiler Error"
        self.code = (
            "Please update solc to the latest version to resolve this issue"
        )
        self.lineno = "-"

    def add_code_info(self, contract) -> None:
        """Attach source-mapping info from the contract when available."""
        if self.address and isinstance(contract, object) and hasattr(
            contract, "get_source_info"
        ):
            is_constructor = "constructor" in (self.function or "")
            try:
                codeinfo = contract.get_source_info(
                    self.address, constructor=is_constructor
                )
            except Exception as e:
                log.debug("source mapping failed: %s", e)
                return
            if codeinfo is None:
                self._set_internal_compiler_error()
                return
            self.filename = codeinfo.filename
            self.code = codeinfo.code
            self.lineno = codeinfo.lineno
            if self.lineno is None:
                self._set_internal_compiler_error()
            self.source_mapping = codeinfo.solc_mapping
        else:
            self.source_mapping = self.address

    def resolve_function_name(self):
        """Resolve `_function_0x...` placeholders through the signature
        database."""
        if self.function is None or not self.function.startswith(
            "_function_0x"
        ):
            return
        sigs = SignatureDB().get(self.function[len("_function_") :])
        if sigs:
            self.function = sigs[0]


def get_code_hash(code) -> str:
    from ..support.support_utils import get_code_hash as _gch

    try:
        return _gch(code)
    except Exception:
        return ""


class Report:
    """Collects issues over all analyzed contracts and renders them."""

    environment: Dict[str, Any] = {}

    def __init__(self, contracts=None, exceptions=None,
                 execution_info: Optional[List[ExecutionInfo]] = None):
        self.issues: Dict[bytes, Issue] = {}
        self.solc_version = ""
        self.meta: Dict[str, Any] = {}
        self.source = Source()
        self.source.get_source_from_contracts_list(contracts)
        self.exceptions = exceptions or []
        self.execution_info = execution_info or []

    def sorted_issues(self) -> List[Dict[str, Any]]:
        issue_list = [issue.as_dict for issue in self.issues.values()]
        return sorted(
            issue_list, key=operator.itemgetter("address", "title")
        )

    def append_issue(self, issue: Issue) -> None:
        """Deduplicate on (contract, function, address, title) — the
        function name must participate (reference report.py:273-281), or
        distinct violations routed through a shared helper block (e.g.
        solc 0.8's panic routine) collapse into one issue."""
        m = hashlib.md5()
        m.update(
            (
                issue.contract
                + issue.function
                + str(issue.address)
                + issue.title
            ).encode("utf-8")
        )
        issue.resolve_function_name()
        self.issues[m.digest()] = issue

    def as_text(self) -> str:
        name = self._file_name()
        text = ""
        for issue in self.issues.values():
            text += (
                "==== {} ====\n"
                "SWC ID: {}\n"
                "Severity: {}\n"
                "Contract: {}\n"
                "Function name: {}\n"
                "PC address: {}\n"
                "Estimated Gas Usage: {} - {}\n"
                "{}\n{}\n".format(
                    issue.title,
                    issue.swc_id,
                    issue.severity,
                    issue.contract or name,
                    issue.function,
                    issue.address,
                    issue.min_gas_used,
                    issue.max_gas_used,
                    issue.description_head,
                    issue.description_tail,
                )
            )
            if issue.filename and issue.lineno:
                text += "In file: {}:{}\n".format(
                    issue.filename, issue.lineno
                )
            if issue.code:
                text += "\n{}\n".format(issue.code)
            if issue.transaction_sequence:
                text += "\nTransaction Sequence:\n\n"
                text += self._format_tx_sequence(
                    issue.transaction_sequence
                )
            text += "\n--------------------\n"
        if not text:
            return "The analysis was completed successfully. " \
                   "No issues were detected.\n"
        return text

    @staticmethod
    def _format_tx_sequence(seq: Dict) -> str:
        out = ""
        init = seq.get("initialState", {}).get("accounts", {})
        if init:
            out += "Initial State:\n\n"
            for addr, acc in init.items():
                out += "Account: [{}], balance: {}, nonce:{}, " \
                       "storage:{}\n".format(
                           addr.upper(), acc.get("balance"),
                           acc.get("nonce"), acc.get("storage"),
                       )
            out += "\n"
        for i, step in enumerate(seq.get("steps", [])):
            kind = (
                "CONTRACT_CREATION" if step.get("address") == ""
                else "CALL"
            )
            out += "Transaction {} [{}]: from: {} value: {} " \
                   "data: {}\n".format(
                       i + 1, kind, step.get("origin"),
                       step.get("value"), step.get("calldata"),
                   )
        return out

    def as_json(self) -> str:
        result = {
            "success": True,
            "error": None,
            "issues": self.sorted_issues(),
        }
        return json.dumps(result, sort_keys=True)

    def _file_name(self) -> Optional[str]:
        if (
            len(self.source.source_list) > 0
            and self.source.source_list[0] is not None
        ):
            return self.source.source_list[0].split(":")[0]
        return None

    def as_swc_standard_format(self) -> str:
        """SWC-standard 'jsonv2' output."""
        _issues = []
        for issue in self.issues.values():
            idx = self.source.get_source_index(issue.bytecode_hash)
            try:
                title = SWC_TO_TITLE[issue.swc_id]
            except KeyError:
                title = "Unspecified Security Issue"
            extra = {"discoveryTime": int(issue.discovery_time * 10**9)}
            if issue.transaction_sequence:
                extra["testCases"] = [issue.transaction_sequence]
            _issues.append(
                {
                    "swcID": "SWC-" + issue.swc_id,
                    "swcTitle": title,
                    "description": {
                        "head": issue.description_head,
                        "tail": issue.description_tail,
                    },
                    "severity": issue.severity,
                    "locations": [
                        {
                            "sourceMap": "%d:1:%d"
                            % (issue.address, idx)
                        }
                    ],
                    "extra": extra,
                }
            )
        meta_data = self._get_exception_data()
        result = [
            {
                "issues": _issues,
                "sourceType": self.source.source_type,
                "sourceFormat": self.source.source_format,
                "sourceList": self.source.source_list,
                "meta": meta_data,
            }
        ]
        return json.dumps(result, sort_keys=True)

    def as_markdown(self) -> str:
        filename = self._file_name()
        template = "# Analysis results for {}\n\n".format(filename)
        if not self.issues:
            template += "The analysis was completed successfully. " \
                        "No issues were detected.\n"
            return template
        for issue in self.issues.values():
            template += (
                "## {}\n- SWC ID: {}\n- Severity: {}\n"
                "- Contract: {}\n- Function name: `{}`\n"
                "- PC address: {}\n"
                "- Estimated Gas Usage: {} - {}\n\n"
                "### Description\n\n{}\n{}\n".format(
                    issue.title,
                    issue.swc_id,
                    issue.severity,
                    issue.contract,
                    issue.function,
                    issue.address,
                    issue.min_gas_used,
                    issue.max_gas_used,
                    issue.description_head,
                    issue.description_tail,
                )
            )
            if issue.filename and issue.lineno:
                template += "\nIn file: {}:{}\n".format(
                    issue.filename, issue.lineno
                )
            template += "\n"
        return template

    def _get_exception_data(self) -> dict:
        if not self.exceptions:
            return {}
        logs: List[Dict] = []
        for exception in self.exceptions:
            logs += [{"level": "error", "hidden": True,
                      "msg": exception}]
        return {"logs": logs}
