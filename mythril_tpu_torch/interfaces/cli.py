"""`myth` command-line interface (capability parity:
mythril/interfaces/cli.py:243-979).

Command tree: analyze (a), disassemble (d), concolic, foundry,
safe-functions, read-storage, list-detectors, function-to-hash,
hash-to-address, version, help — with the full analysis flag set
(strategy, timeouts, tx count, module selection, output formats,
on-chain loading) plus this build's TPU lane-engine knobs."""

import argparse
import json
import logging
import os
import sys
from typing import Optional

try:  # optional dependency: colored console logs
    import coloredlogs  # type: ignore[import-untyped]
except ImportError:  # pragma: no cover - plain logging fallback
    coloredlogs = None

from .. import __version__
from ..analysis.module.loader import ModuleLoader
from ..exceptions import (
    CriticalError,
    DetectorNotFoundError,
)
from ..orchestration.mythril_analyzer import MythrilAnalyzer
from ..orchestration.mythril_config import MythrilConfig
from ..orchestration.mythril_disassembler import MythrilDisassembler
from ..support.support_args import args as global_args

log = logging.getLogger(__name__)

ANALYZE_LIST = ("analyze", "a")
DISASSEMBLE_LIST = ("disassemble", "d")

COMMAND_LIST = (
    ANALYZE_LIST
    + DISASSEMBLE_LIST
    + (
        "concolic",
        "foundry",
        "safe-functions",
        "read-storage",
        "list-detectors",
        "function-to-hash",
        "hash-to-address",
        "serve",
        "version",
        "help",
    )
)


def exit_with_error(format_: Optional[str], message: str) -> None:
    """Print the error in the selected output format and exit(1)."""
    if format_ in (None, "text", "markdown"):
        log.error(message)
    elif format_ == "json":
        print(json.dumps({"success": False, "error": str(message),
                          "issues": []}))
    else:
        print(
            json.dumps(
                [
                    {
                        "issues": [],
                        "sourceType": "",
                        "sourceFormat": "",
                        "sourceList": [],
                        "meta": {"logs": [
                            {"level": "error", "hidden": True,
                             "msg": message}
                        ]},
                    }
                ]
            )
        )
    sys.exit(1)


# ---------------------------------------------------------------------------
# parser construction
# ---------------------------------------------------------------------------


def get_input_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument(
        "solidity_files",
        nargs="*",
        help="Inputs file name and contract name. Use it as "
             "file_name:contract_name",
    )
    return parser


def get_output_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument(
        "-o", "--outform",
        choices=["text", "markdown", "json", "jsonv2"],
        default="text",
        help="report output format",
    )
    parser.add_argument(
        "--verbose-report", action="store_true",
        help="Include debugging information in report",
    )
    return parser


def get_rpc_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument(
        "--rpc",
        help="custom RPC settings",
        metavar="HOST:PORT / ganache / infura-[network_name]",
        default="infura-mainnet",
    )
    parser.add_argument(
        "--rpctls", type=bool, default=False,
        help="RPC connection over TLS",
    )
    parser.add_argument("--infura-id", help="set infura id for onchain "
                                            "analysis")
    return parser


def get_utilities_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--solc-json",
                        help="Json for the optional 'settings' parameter of "
                             "solc's standard-json input")
    parser.add_argument("--solv",
                        help="specify solidity compiler version.",
                        metavar="SOLV")
    return parser


def add_graph_commands(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-g", "--graph",
                        help="generate a control flow graph",
                        metavar="OUTPUT_FILE")
    parser.add_argument("-j", "--statespace-json",
                        help="dumps the statespace json",
                        metavar="OUTPUT_FILE")
    parser.add_argument("--enable-physics", action="store_true",
                        help="enable graph physics simulation")
    parser.add_argument("--phrack", action="store_true",
                        help="phrack-style text graph")


def create_code_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("-c", "--code",
                        help='hex-encoded bytecode string '
                             '("6060604052...")',
                        metavar="BYTECODE")
    parser.add_argument("-f", "--codefile",
                        help="file containing hex-encoded bytecode string",
                        metavar="BYTECODEFILE",
                        type=argparse.FileType("r"))
    parser.add_argument("-a", "--address",
                        help="pull contract from the blockchain",
                        metavar="CONTRACT_ADDRESS")
    parser.add_argument("--bin-runtime", action="store_true",
                        help="Only when -c or -f is used. Consider the "
                             "input bytecode as binary runtime code")


def add_analysis_args(options: argparse._ArgumentGroup) -> None:
    """The ~30 analysis flags (reference cli.py:439-584)."""
    options.add_argument("-m", "--modules",
                        help="Comma-separated list of security analysis "
                             "modules", metavar="MODULES")
    options.add_argument("--max-depth", type=int, default=128,
                        help="Maximum recursion depth for symbolic "
                             "execution")
    options.add_argument("--call-depth-limit", type=int, default=3,
                        help="Maximum call depth limit for symbolic "
                             "execution")
    options.add_argument("--strategy",
                        choices=["dfs", "bfs", "naive-random",
                                 "weighted-random", "delayed"],
                        default="bfs",
                        help="Symbolic execution strategy")
    options.add_argument("-b", "--loop-bound", type=int, default=3,
                        help="Bound loops at n iterations",
                        metavar="N")
    options.add_argument("-t", "--transaction-count", type=int, default=2,
                        help="Maximum number of transactions issued by "
                             "laser")
    options.add_argument("--beam-search", type=int, default=None,
                        help="Beam search with with given beam width",
                        metavar="BEAM_WIDTH")
    options.add_argument("-tx", "--transaction-sequences",
                        type=str, default=None,
                        help="The possible transaction sequences to be "
                             "executed. Like [[func_hash1, func_hash2], "
                             "[func_hash2, func_hash3]] where for the first "
                             "transaction is constrained with func_hash1 and "
                             "func_hash2, and the second tx is constrained "
                             "with func_hash2 and func_hash3. Use -1 as a "
                             "proxy for fallback() and -2 for receive()")
    options.add_argument("--execution-timeout", type=int, default=86400,
                        help="The amount of seconds to spend on symbolic "
                             "execution")
    options.add_argument("--solver-timeout", type=int, default=10000,
                        help="The maximum amount of time(in milli seconds) "
                             "the solver spends for queries from analysis "
                             "modules")
    options.add_argument("--create-timeout", type=int, default=10,
                        help="The amount of seconds to spend on the initial "
                             "contract creation")
    options.add_argument("--parallel-solving", action="store_true",
                        help="Enable solving z3 queries in parallel")
    options.add_argument("--solver-log",
                        help="Path to the directory for solver log",
                        metavar="SOLVER_LOG")
    options.add_argument("--no-onchain-data", action="store_true",
                        help="Don't attempt to retrieve contract code, "
                             "variables and balances from the blockchain")
    options.add_argument("--pruning-factor", type=float, default=None,
                        help="Checks for reachability at the percentage "
                             "of floor(pruning_factor * depth) of the tree")
    options.add_argument("--unconstrained-storage", action="store_true",
                        help="Default storage value is symbolic, turns off "
                             "the on-chain storage loading")
    options.add_argument("--attacker-address",
                        help="Designates a specific attacker address to "
                             "use during analysis",
                        metavar="ATTACKER_ADDRESS")
    options.add_argument("--creator-address",
                        help="Designates a specific creator address to use "
                             "during analysis",
                        metavar="CREATOR_ADDRESS")
    options.add_argument("--custom-modules-directory",
                        help="Designates a separate directory to search for "
                             "custom analysis modules",
                        metavar="CUSTOM_MODULES_DIRECTORY", default="")
    options.add_argument("--enable-iprof", action="store_true",
                        help="enable the instruction profiler")
    options.add_argument("--enable-coverage-strategy", action="store_true",
                        help="enable coverage based search strategy")
    options.add_argument("--disable-dependency-pruning", action="store_true",
                        help="Deactivate dependency-based pruning")
    options.add_argument("--disable-mutation-pruner", action="store_true",
                        help="Deactivate mutation pruner")
    options.add_argument("--disable-integer-module", action="store_true",
                        help="Disables the Integer detection module")
    options.add_argument("--disable-iprof", action="store_true",
                        help=argparse.SUPPRESS)
    options.add_argument("-q", "--query-signature", action="store_true",
                        help="Lookup function signatures through "
                             "www.4byte.directory")
    options.add_argument("--enable-summaries", action="store_true",
                        help=argparse.SUPPRESS)
    # TPU lane-engine knobs (new in this build)
    options.add_argument("--tpu-lanes", type=int,
                        default=global_args.tpu_lanes,
                        help="Batched lane-engine width (-1 = auto: "
                             "batched lanes on a local accelerator, "
                             "host-only otherwise; 0 = host-only "
                             "reference engine; >0 = JAX/TPU batched "
                             "execution with N lanes)")
    options.add_argument("--tpu-mesh", type=int,
                        default=global_args.tpu_mesh,
                        help="Shard lane planes over a device mesh "
                             "(-1 = auto: all local devices when >1; "
                             "0 = single device; N = use N devices)")
    options.add_argument("--no-tpu-prefilter", action="store_true",
                        help="Disable the on-device interval/bit "
                             "constraint pre-filter")
    options.add_argument("--checkpoint", metavar="FILE", default=None,
                        help="Checkpoint the analysis after each "
                             "symbolic transaction round; if FILE "
                             "already holds a snapshot, resume from it")
    options.add_argument("--resume", metavar="DIR", default=None,
                        help="Resume a crashed/preempted run from the "
                             "live checkpoint a previous run left "
                             "under DIR (flightrec/resume_rank*.ckpt "
                             "from a SIGTERM/fatal dump, or "
                             "resume.ckpt) and keep checkpointing "
                             "there — docs/checkpoint.md. Overridden "
                             "by an explicit --checkpoint FILE")
    options.add_argument("--trace-out", metavar="FILE", default=None,
                        help="Record structured telemetry spans "
                             "(implies MTPU_TRACE=1) and write a "
                             "Chrome trace-event JSON to FILE at exit "
                             "(load in Perfetto; a FILE+'l' JSONL "
                             "twin rides along — "
                             "docs/observability.md)")
    options.add_argument("--no-warm-store", action="store_true",
                        help="Disable the cross-run warm store "
                             "(support/warm_store.py: code-hash-keyed "
                             "persistence of proofs, static "
                             "artifacts, and learned solver routing "
                             "under MTPU_WARM_DIR or a corpus "
                             "--out-dir/warm). Same as MTPU_WARM=0 — "
                             "bit-for-bit cold behavior "
                             "(docs/warm_store.md)")
    options.add_argument("--daemon", metavar="SOCK", default=None,
                        help="Submit this analysis to a resident "
                             "`myth serve` daemon listening on SOCK "
                             "instead of analyzing in-process, and "
                             "stream back the report (warm jit "
                             "caches, hot solver sessions, shared "
                             "warm store — docs/daemon.md). Also "
                             "settable via MTPU_DAEMON; unset/empty "
                             "keeps the one-shot path bit-for-bit. "
                             "Bytecode inputs (-c/-f) only")


def create_analyzer_parser(parser: argparse.ArgumentParser) -> None:
    create_code_parser(parser)
    add_graph_commands(parser)
    options = parser.add_argument_group("options")
    add_analysis_args(options)


def create_safe_functions_parser(parser: argparse.ArgumentParser) -> None:
    create_code_parser(parser)
    options = parser.add_argument_group("options")
    add_analysis_args(options)


def create_concolic_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("input",
                        help="The input jsonv2 file with concrete data")
    parser.add_argument("--branches",
                        help="Comma-separated branch addresses to flip",
                        metavar="BRANCHES", required=True)


def create_disassemble_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("solidity_files", nargs="*",
                        help="Inputs file name and contract name")
    create_code_parser(parser)


def create_read_storage_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("storage_slots",
                        help="read state variables from storage index",
                        metavar="INDEX,NUM_SLOTS,[array] / "
                                "INDEX,mapping,KEY...")
    parser.add_argument("address",
                        help="contract address",
                        metavar="CONTRACT_ADDRESS")


def create_func_to_hash_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("func_name", help="calculate function signature "
                                          "hash", metavar="SIGNATURE")


def create_hash_to_addr_parser(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("hash", help="Find the address from hash",
                        metavar="FUNCTION_NAME")


def main() -> None:
    """The `myth` entry point (reference cli.py:243)."""
    rpc_parser = get_rpc_parser()
    utilities_parser = get_utilities_parser()
    input_parser = get_input_parser()
    output_parser = get_output_parser()

    parser = argparse.ArgumentParser(
        description="Security analysis of Ethereum smart contracts "
                    "(TPU-native rebuild)"
    )
    parser.add_argument("--epic", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("-v", type=int, default=2,
                        help="log level (0-5)", metavar="LOG_LEVEL")
    subparsers = parser.add_subparsers(dest="command", help="Commands")

    analyzer_parser = subparsers.add_parser(
        ANALYZE_LIST[0], aliases=ANALYZE_LIST[1:],
        help="Triggers the analysis of the smart contract",
        parents=[rpc_parser, utilities_parser, input_parser, output_parser],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    create_analyzer_parser(analyzer_parser)

    disassemble_parser = subparsers.add_parser(
        DISASSEMBLE_LIST[0], aliases=DISASSEMBLE_LIST[1:],
        help="Disassembles the smart contract",
        parents=[rpc_parser, utilities_parser],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    create_disassemble_parser(disassemble_parser)

    concolic_parser = subparsers.add_parser(
        "concolic",
        help="Runs concolic execution to flip branches",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    create_concolic_parser(concolic_parser)

    foundry_parser = subparsers.add_parser(
        "foundry",
        help="Triggers the analysis of the foundry project",
        parents=[rpc_parser, utilities_parser, output_parser],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    options = foundry_parser.add_argument_group("options")
    add_analysis_args(options)
    add_graph_commands(foundry_parser)

    safe_functions_parser = subparsers.add_parser(
        "safe-functions",
        help="Check functions which are completely safe using symbolic "
             "execution",
        parents=[rpc_parser, utilities_parser, input_parser, output_parser],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    create_safe_functions_parser(safe_functions_parser)

    read_storage_parser = subparsers.add_parser(
        "read-storage",
        help="Retrieves storage slots from a given address through rpc",
        parents=[rpc_parser],
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    create_read_storage_parser(read_storage_parser)

    serve_parser = subparsers.add_parser(
        "serve",
        help="Run a resident analysis daemon: a long-lived process "
             "serving `myth analyze --daemon SOCK` submissions with "
             "warm jit caches, hot solver sessions, and one shared "
             "warm store (docs/daemon.md)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    serve_parser.add_argument("--out-dir", required=True,
                              metavar="DIR",
                              help="daemon state root: the socket "
                                   "(DIR/daemon.sock), shared warm "
                                   "store (DIR/warm), cost model "
                                   "(DIR/stats.json), per-request "
                                   "artifacts (DIR/requests/), and "
                                   "the resumable queue")
    serve_parser.add_argument("--socket", metavar="SOCK", default=None,
                              help="listen on SOCK instead of "
                                   "DIR/daemon.sock")
    serve_parser.add_argument("--workers", type=int, default=1,
                              help="concurrent analysis workers "
                                   "(K=1 default per the single-CPU "
                                   "pool policy)")

    subparsers.add_parser(
        "list-detectors",
        parents=[output_parser],
        help="Lists available detection modules",
    )
    func_to_hash_parser = subparsers.add_parser(
        "function-to-hash", help="Returns the hash of a function signature"
    )
    create_func_to_hash_parser(func_to_hash_parser)
    hash_to_addr_parser = subparsers.add_parser(
        "hash-to-address",
        help="Returns the functions from signature database for the hash",
    )
    create_hash_to_addr_parser(hash_to_addr_parser)
    subparsers.add_parser("version", parents=[output_parser],
                          help="Outputs the version")
    subparsers.add_parser("help", add_help=False)

    args = parser.parse_args()
    parse_args_and_execute(parser=parser, args=args)


def validate_args(args: argparse.Namespace) -> None:
    """Cross-flag validation (reference cli.py:610-668)."""
    if args.__dict__.get("v", 2):
        if 0 <= args.v < 6:
            levels = [
                logging.NOTSET, logging.CRITICAL, logging.ERROR,
                logging.WARNING, logging.INFO, logging.DEBUG,
            ]
            if coloredlogs is not None:
                coloredlogs.install(
                    fmt="%(name)s [%(levelname)s]: %(message)s",
                    level=levels[args.v],
                )
            else:
                logging.basicConfig(
                    format="%(name)s [%(levelname)s]: %(message)s",
                    level=levels[args.v],
                )
            logging.getLogger("mythril_tpu_torch").setLevel(levels[args.v])
        else:
            exit_with_error(
                args.__dict__.get("outform", "text"),
                "Invalid -v value, you can find valid values in usage",
            )
    if args.command in ANALYZE_LIST:
        if args.query_signature:
            pass  # online lookup enabled lazily by SignatureDB
        if args.enable_iprof and args.v < 4:
            exit_with_error(
                args.__dict__.get("outform", "text"),
                "--enable-iprof must be used with -v LOG_LEVEL where "
                "LOG_LEVEL >= 4",
            )


def set_config(args: argparse.Namespace) -> MythrilConfig:
    config = MythrilConfig()
    if args.__dict__.get("infura_id"):
        config.set_api_infura_id(args.infura_id)
    if (args.command in ANALYZE_LIST and not args.no_onchain_data) or (
        args.command in ("read-storage",) + DISASSEMBLE_LIST
        and args.__dict__.get("rpc")
    ):
        try:
            config.set_api_rpc(rpc=args.rpc, rpctls=args.rpctls)
        except Exception as e:
            log.debug("could not set up RPC: %s", e)
    return config


def load_code(disassembler: MythrilDisassembler,
              args: argparse.Namespace) -> str:
    """Resolve -c/-f/-a/solidity file inputs to a loaded contract
    (reference cli.py:692-754)."""
    address = None
    if args.__dict__.get("code"):
        address, _ = disassembler.load_from_bytecode(
            args.code, args.bin_runtime)
    elif args.__dict__.get("codefile"):
        bytecode = "".join(
            [l.strip() for l in args.codefile if len(l.strip()) > 0]
        )
        address, _ = disassembler.load_from_bytecode(
            bytecode, args.bin_runtime)
    elif args.__dict__.get("address"):
        address, _ = disassembler.load_from_address(args.address)
    elif args.__dict__.get("solidity_files"):
        address, _ = disassembler.load_from_solidity(args.solidity_files)
    else:
        exit_with_error(
            args.__dict__.get("outform", "text"),
            "No input bytecode. Please provide EVM code via -c BYTECODE, "
            "-a ADDRESS, -f BYTECODE_FILE or <SOLIDITY_FILE>",
        )
    return address


def print_function_report(disassembler: MythrilDisassembler,
                          report) -> None:
    """safe-functions output: functions with no issues are 'safe'."""
    issue_functions = {
        issue["function"] for issue in report.sorted_issues()
    }
    for contract in disassembler.contracts:
        all_functions = set(
            contract.disassembly.address_to_function_name.values()
        )
        safe = sorted(all_functions - issue_functions)
        print(
            "The following functions are deemed safe in contract "
            f"{contract.name}: {safe}"
        )


def execute_command(
    disassembler: MythrilDisassembler,
    address: str,
    parser: argparse.ArgumentParser,
    args: argparse.Namespace,
) -> None:
    """Dispatch the parsed command (reference cli.py:756-888)."""
    if args.command in DISASSEMBLE_LIST:
        if disassembler.contracts[0].code:
            print("Runtime Disassembly: \n" +
                  disassembler.contracts[0].get_easm())
        if disassembler.contracts[0].creation_code:
            print("Disassembly: \n" +
                  disassembler.contracts[0].get_creation_easm())
        return

    if args.command in ANALYZE_LIST + ("foundry", "safe-functions"):
        analyzer = MythrilAnalyzer(
            strategy=get_analysis_strategy(args),
            disassembler=disassembler,
            address=address,
            cmd_args=args,
        )

        if args.__dict__.get("disable_integer_module"):
            global_args.use_integer_module = False
        if args.__dict__.get("disable_mutation_pruner"):
            global_args.disable_mutation_pruner = True
        if not args.__dict__.get("enable_coverage_strategy", False):
            global_args.disable_coverage_strategy = True
        if args.__dict__.get("no_tpu_prefilter"):
            global_args.tpu_prefilter = False

        if args.__dict__.get("graph"):
            html = analyzer.graph_html(
                contract=analyzer.contracts[0],
                enable_physics=args.enable_physics,
                phrackify=args.phrack,
                transaction_count=args.transaction_count,
            )
            try:
                with open(args.graph, "w") as f:
                    f.write(html)
            except Exception as e:
                exit_with_error(args.outform,
                                "Error saving graph: " + str(e))
            return
        if args.__dict__.get("statespace_json"):
            try:
                with open(args.statespace_json, "w") as f:
                    f.write(analyzer.dump_statespace(
                        contract=analyzer.contracts[0]))
            except Exception as e:
                exit_with_error(args.outform,
                                "Error saving statespace: " + str(e))
            return

        modules = (
            [m.strip() for m in args.modules.strip().split(",")]
            if args.modules else []
        )
        transaction_count = args.transaction_count
        try:
            report = analyzer.fire_lasers(
                modules=modules,
                transaction_count=transaction_count,
            )
        except DetectorNotFoundError as e:
            exit_with_error(args.outform, format(e))
            return
        except CriticalError as e:
            exit_with_error(
                args.outform, "Analysis error encountered: " + format(e)
            )
            return

        if args.command == "safe-functions":
            print_function_report(disassembler, report)
            return
        outputs = {
            "json": report.as_json(),
            "jsonv2": report.as_swc_standard_format(),
            "text": report.as_text(),
            "markdown": report.as_markdown(),
        }
        print(outputs[args.outform])
        # exit code 1 iff issues were found (reference cli.py:876-879)
        sys.exit(1 if report.issues else 0)

    if args.command == "read-storage":
        print(disassembler.get_state_variable_from_storage(
            address=args.address,
            params=[a.strip() for a in args.storage_slots.strip().split(",")],
        ))
        return

    parser.print_help()


def get_analysis_strategy(args: argparse.Namespace) -> str:
    if args.__dict__.get("beam_search"):
        return "beam-search: " + str(args.beam_search)
    return args.__dict__.get("strategy", "bfs")


def contract_hash_to_address(args: argparse.Namespace) -> None:
    """hash-to-address: look up the signature DB for a 4-byte selector."""
    from ..support.signatures import SignatureDB

    if not args.hash.startswith("0x") or len(args.hash) != 10:
        exit_with_error("text", "Invalid function hash (expected 0x + 8 "
                                "hex digits)")
    sigs = SignatureDB(enable_online_lookup=True)
    matches = sigs.get(args.hash)
    if not matches:
        print("No matches found")
    for match in matches:
        print(match)
    sys.exit(0)


def _try_daemon_analyze(args: argparse.Namespace) -> bool:
    """Route an eligible analyze invocation through a resident daemon
    (docs/daemon.md). Returns True when the request was fully served
    (output printed, exit via sys.exit); False when no daemon is
    configured or the input shape needs the one-shot path — which then
    runs bit-for-bit as before (the MTPU_DAEMON master-gate
    contract)."""
    if args.command not in ANALYZE_LIST:
        return False
    from ..daemon import configured_socket

    sock = configured_socket(args.__dict__.get("daemon"))
    if not sock:
        return False
    if args.__dict__.get("graph") or args.__dict__.get(
            "statespace_json"):
        log.warning("--daemon serves reports only, not graph/"
                    "statespace dumps; analyzing one-shot")
        return False
    code = None
    if args.__dict__.get("code"):
        code = args.code
    elif args.__dict__.get("codefile"):
        code = "".join(
            l.strip() for l in args.codefile if len(l.strip()) > 0)
    if not code:
        log.warning("--daemon serves bytecode inputs (-c/-f); "
                    "analyzing one-shot")
        return False
    modules = (
        [m.strip() for m in args.modules.strip().split(",")]
        if args.__dict__.get("modules") else None
    )
    from ..daemon.client import DaemonError, analyze_via_daemon

    try:
        # every analyzer-relevant flag travels with the request:
        # report identity with the one-shot path holds because the
        # daemon runs the SAME configuration, not its own defaults
        row = analyze_via_daemon(
            sock, code, outform=args.outform,
            bin_runtime=bool(args.__dict__.get("bin_runtime")),
            timeout=args.execution_timeout,
            tpu_lanes=args.tpu_lanes,
            transaction_count=args.transaction_count,
            modules=modules,
            strategy=get_analysis_strategy(args),
            max_depth=args.max_depth,
            call_depth_limit=args.call_depth_limit,
            loop_bound=args.loop_bound,
            create_timeout=args.create_timeout,
            solver_timeout=args.solver_timeout,
            no_onchain_data=bool(args.no_onchain_data),
            pruning_factor=args.pruning_factor,
            unconstrained_storage=bool(args.unconstrained_storage),
            disable_dependency_pruning=bool(
                args.disable_dependency_pruning),
            transaction_sequences=args.transaction_sequences)
    except (DaemonError, OSError) as e:
        exit_with_error(args.outform, f"daemon analysis failed: {e}")
        return True
    print(row["output"])
    # same exit-code contract as the one-shot path: 1 iff issues
    sys.exit(1 if row.get("issue_count") else 0)


def parse_args_and_execute(parser: argparse.ArgumentParser,
                           args: argparse.Namespace) -> None:
    if args.epic:
        mythril_dir = os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))
        sys.argv.remove("--epic")
        os.execvp("python3", ["python3", os.path.join(
            mythril_dir, "interfaces", "epic.py")] + sys.argv)
        return

    if args.command not in COMMAND_LIST or args.command is None:
        parser.print_help()
        sys.exit(0)

    if args.command == "version":
        if args.outform == "json":
            print(json.dumps({"version_str": __version__}))
        else:
            print("Mythril-TPU version {}".format(__version__))
        sys.exit(0)

    if args.command == "list-detectors":
        modules = []
        for module in ModuleLoader().get_detection_modules():
            modules.append({
                "classname": type(module).__name__,
                "title": module.name,
                "swc_id": module.swc_id,
                "description": module.description,
            })
        if args.outform == "json":
            print(json.dumps(modules))
        else:
            for module_data in modules:
                print("{}: {}".format(module_data["classname"],
                                      module_data["title"]))
        sys.exit(0)

    if args.command == "function-to-hash":
        print(MythrilDisassembler.hash_for_function_signature(
            args.func_name))
        sys.exit(0)

    if args.command == "hash-to-address":
        contract_hash_to_address(args)
        return

    if args.command == "help":
        parser.print_help()
        sys.exit(0)

    validate_args(args)
    if args.command == "serve":
        from ..daemon.server import serve

        try:
            sys.exit(serve(args.out_dir, socket_path=args.socket,
                           workers=args.workers))
        except KeyboardInterrupt:
            sys.exit(0)
        except OSError as e:
            exit_with_error("text", f"daemon startup failed: {e}")
    try:
        if _try_daemon_analyze(args):
            return
        if args.command == "concolic":
            from ..concolic.concolic_execution import concolic_execution

            with open(args.input) as f:
                concrete_data = json.load(f)
            branches = [int(b, 0) for b in args.branches.split(",")]
            output_list = concolic_execution(concrete_data, branches)
            print(json.dumps(output_list, indent=4))
            sys.exit(0)

        config = set_config(args)
        query_signature = args.__dict__.get("query_signature", False)
        solc_json = args.__dict__.get("solc_json", None)
        solv = args.__dict__.get("solv", None)
        disassembler = MythrilDisassembler(
            eth=config.eth,
            solc_version=solv,
            solc_settings_json=solc_json,
            enable_online_lookup=query_signature,
        )
        if args.command == "foundry":
            address, _ = disassembler.load_from_foundry()
        elif args.command == "read-storage":
            address = args.address
        else:
            address = load_code(disassembler, args)
        execute_command(
            disassembler=disassembler, address=address,
            parser=parser, args=args,
        )
    except CriticalError as ce:
        exit_with_error(args.__dict__.get("outform", "text"), str(ce))
    except Exception:
        log.exception("Unhandled exception")
        exit_with_error(
            args.__dict__.get("outform", "text"),
            "Unhandled exception during analysis",
        )


if __name__ == "__main__":
    main()
