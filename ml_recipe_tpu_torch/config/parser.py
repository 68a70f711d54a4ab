"""Layered file+CLI config system (the port of ``ml_recipe_tpu/config/parser.py``).

``key = value`` config files are pre-parsed into defaults, and keys a parser
does not know come back from ``parse_known_args`` so ``get_params`` can
route one cfg file to several parsers and fail only on keys no parser
knows. The model and serve parsers carry the JAX package's flags, so
``config/serve.cfg`` parses unchanged, plus one flag of the port's own:
``--device`` (``cuda`` by default; ``cpu`` only when asked for).

:func:`check_serve_flags` holds the serve entry point to what the port
implements: a flag whose subsystem is not ported yet and which would change
results at a non-default value raises ``NotImplementedError`` naming its
ROADMAP.md item; flags with no port counterpart that change no result are
accepted and logged once as not ported.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from ..models.config import MODEL_PRESETS

logger = logging.getLogger(__name__)


def cast2(type_):
    """'None'-string-aware cast (reference parser.py:34-35)."""
    return lambda x: type_(x) if x != "None" else None


def _str2bool(value: str) -> bool:
    return str(value).strip().lower() in ("1", "true", "yes", "on")


def cast_bytes(value) -> int:
    """Byte-budget domain for the serving caches: a plain int, or a
    human-friendly K/M/G(iB) suffix ('64M', '1g'). 0 disables."""
    text = str(value).strip().lower()
    for suffix, mult in (("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30)):
        if text.endswith(suffix):
            return int(float(text[:-1]) * mult)
    return int(text)


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse with configargparse-style ``key = value`` config-file layering.

    Arguments registered with ``is_config_file=True`` name the config-file
    options; files listed there are read before parsing and their values
    injected as defaults (CLI always wins). Keys a parser does not know are
    returned as pseudo-args (``--key=value``) from ``parse_known_args`` so
    multi-parser routing can intersect them (reference parser.py:9-31).
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._config_file_dests: List[str] = []

    def add_argument(self, *args, **kwargs):  # type: ignore[override]
        is_config_file = kwargs.pop("is_config_file", False)
        action = super().add_argument(*args, **kwargs)
        if is_config_file:
            self._config_file_dests.append(action.dest)
        return action

    # -- config file handling -------------------------------------------------

    @staticmethod
    def read_config_file(path) -> dict:
        """Read ``key = value`` lines; '#'/';' comments; later keys win."""
        items: dict = {}
        with open(path, "r") as fh:
            for raw in fh:
                line = raw.strip()
                if not line or line.startswith("#") or line.startswith(";"):
                    continue
                key, sep, value = line.partition("=")
                if not sep:
                    continue
                items[key.strip()] = value.split("#")[0].strip()
        return items

    def _find_config_files(self, args: Sequence[str]) -> List[str]:
        option_names = {}
        for action in self._actions:
            if action.dest in self._config_file_dests:
                for opt in action.option_strings:
                    option_names[opt] = action.dest
        files = []
        it = iter(range(len(args)))
        for i in it:
            arg = args[i]
            if "=" in arg and arg.split("=", 1)[0] in option_names:
                files.append(arg.split("=", 1)[1])
            elif arg in option_names and i + 1 < len(args):
                files.append(args[i + 1])
        return files

    def _apply_config_items(self, items: dict) -> List[str]:
        """Inject known keys as defaults; return unknown keys as pseudo-args."""
        known = {a.dest: a for a in self._actions}
        unknown: List[str] = []
        for key, value in items.items():
            action = known.get(key)
            if action is None or action.dest in self._config_file_dests:
                if action is None:
                    unknown.append(f"--{key}={value}")
                continue
            if isinstance(action, (argparse._StoreTrueAction, argparse._StoreFalseAction)):
                self.set_defaults(**{key: _str2bool(value)})
                continue
            converted = action.type(value) if action.type is not None else value
            # set_defaults skips argparse's choice validation — enforce it
            # here so a config-file typo fails as loudly as a CLI one
            if action.choices is not None and converted not in action.choices:
                self.error(
                    f"argument --{key}: invalid choice: {converted!r} "
                    f"(choose from {', '.join(map(str, action.choices))})"
                )
            self.set_defaults(**{key: converted})
        return unknown

    def parse_known_args(self, args=None, namespace=None):  # type: ignore[override]
        if args is None:
            args = sys.argv[1:]
        args = list(args)
        config_unknown: List[str] = []
        for path in self._find_config_files(args):
            items = self.read_config_file(path)
            config_unknown.extend(self._apply_config_items(items))
        namespace, cli_unknown = super().parse_known_args(args, namespace)
        return namespace, config_unknown + cli_unknown


def get_params(
    parser_getters: Iterable[Callable[[], ConfigArgumentParser]],
    args: Optional[Sequence[str]] = None,
) -> Tuple[list, list]:
    """Parse with several parsers; die only on args *no* parser recognises.

    Reference parity: parser.py:9-31 (unused-arg intersection routing).
    """
    unused = None
    parsers = []
    params = []

    for parser_getter in parser_getters:
        parser = parser_getter()
        parsed_params, unused_params = parser.parse_known_args(args)

        parsers.append(parser)
        params.append(parsed_params)

        unused_set = {u.split("=", 1)[0] for u in unused_params}
        unused = unused_set if unused is None else unused.intersection(unused_set)

    if unused:
        for parser in parsers:
            parser.print_help()
        raise SystemExit(f"Incorrect command line parameters: {sorted(unused)}.")

    return parsers, params


# ---------------------------------------------------------------------------
# Parser factories — flag surface parity with reference parser.py:60-207.
# ---------------------------------------------------------------------------

# derived from the preset registry so the flag and the registry cannot drift
MODEL_CHOICES = list(MODEL_PRESETS)


def get_model_parser() -> ConfigArgumentParser:
    parser = ConfigArgumentParser(description="Model config parser.", add_help=False)

    parser.add_argument("-c", "--config_file", required=False, is_config_file=True,
                        help="Config file path.")
    parser.add_argument("--model_config_file", required=False, is_config_file=True,
                        help="Model config file path.")

    parser.add_argument("--model", type=str, default="bert-base-uncased",
                        choices=MODEL_CHOICES, help="Transformer model name.")

    parser.add_argument("--hidden_dropout_prob", type=float, default=0.1,
                        help="Model dropout probability.")
    parser.add_argument("--attention_probs_dropout_prob", type=float, default=0.1,
                        help="Attention dropout probability.")
    parser.add_argument("--layer_norm_eps", type=float, default=1e-12, help="Layer norm eps.")
    parser.add_argument("--max_position_embeddings", type=cast2(int), default=None,
                        help="Widen the position-embedding table past the "
                             "preset's (required for max_seq_len beyond it — "
                             "positions past the table are a hard error, "
                             "never a silent clamp).")

    parser.add_argument("--vocab_file", type=cast2(str), default=None,
                        help="Path to WordPiece/BPE vocab.")
    parser.add_argument("--merges_file", type=cast2(str), default=None,
                        help="BPE merge table path.")

    parser.add_argument("--lowercase", action="store_true", help="Tokenize lowercase strings.")
    parser.add_argument("--handle_chinese_chars", action="store_true",
                        help="Do not replace chinese symbols with UNK tokens.")

    # additions of the JAX package (no reference counterpart):
    parser.add_argument("--hf_checkpoint", type=cast2(str), default=None,
                        help="HF pretrained dir/name to convert initial weights from "
                             "(None = random init).")
    parser.add_argument("--param_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"], help="Parameter dtype.")
    parser.add_argument("--compute_dtype", type=str, default="bfloat16",
                        choices=["float32", "bfloat16"],
                        help="Activation/matmul dtype (native mixed precision; "
                             "replaces Apex AMP levels).")
    parser.add_argument("--flash_attention", type=cast2(str), default="auto",
                        choices=[None, "auto", "pallas", "xla", "ring"],
                        help="Attention implementation: auto / pallas (the "
                             "fused attention kernel on CUDA, its plain "
                             "version on the CPU), xla (the plain version), "
                             "or ring (sequence-parallel; not ported yet).")
    parser.add_argument("--remat", action="store_true",
                        help="Rematerialize encoder layers (jax.checkpoint) to trade "
                             "FLOPs for HBM.")
    parser.add_argument("--ln_impl", type=cast2(str), default="xla",
                        choices=[None, "xla", "fused", "auto", "interpret"],
                        help="LayerNorm implementation: xla (default, plain "
                             "PyTorch LayerNorm); the fused kernels are not "
                             "ported yet.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Port only: torch device of the model. The "
                             "default needs CUDA and never falls back to the "
                             "CPU; pass 'cpu' to run there on purpose.")

    return parser


def get_serve_parser() -> ConfigArgumentParser:
    """Online-serving config ([serve] surface): bucket grid, micro-batch
    deadline, bounded-queue backpressure, HTTP bind, drain budget. No
    reference counterpart — the reference stack is offline-only."""
    parser = ConfigArgumentParser(description="Serve config parser.", add_help=False)

    parser.add_argument("-c", "--config_file", required=False, is_config_file=True,
                        help="Config file path.")
    parser.add_argument("--serve_config_file", required=False, is_config_file=True,
                        help="Serve config file path.")

    parser.add_argument("--checkpoint", type=cast2(str), default=None,
                        help="Restored checkpoint path (None = random init — "
                             "smoke/bench only).")

    parser.add_argument("--host", type=str, default="127.0.0.1",
                        help="HTTP bind address.")
    parser.add_argument("--port", type=int, default=8080,
                        help="HTTP bind port (0 = ephemeral).")

    parser.add_argument("--buckets", type=str, default="8x128,8x384,32x384",
                        help="Serving bucket grid 'BATCHxSEQ,...': the fixed "
                             "set of pre-compiled (batch, seq) programs. A "
                             "chunk runs in the smallest seq bucket that "
                             "fits it; concurrent chunks coalesce up to the "
                             "bucket batch.")
    parser.add_argument("--max_batch_delay_ms", type=float, default=10.0,
                        help="Micro-batch deadline: a queued chunk waits at "
                             "most this long for co-riders before its "
                             "bucket launches (a full bucket launches "
                             "immediately).")
    parser.add_argument("--queue_size", type=int, default=256,
                        help="Bounded work-queue size in CHUNKS; admission "
                             "past it is rejected with 429 (backpressure) "
                             "instead of growing unboundedly.")
    parser.add_argument("--request_timeout_s", type=float, default=60.0,
                        help="Per-request completion deadline (504 past it).")
    parser.add_argument("--drain_timeout_s", type=float, default=30.0,
                        help="SIGTERM drain budget: flush admitted work and "
                             "close within this long.")

    parser.add_argument("--max_question_len", type=int, default=64,
                        help="Max question length in tokens.")
    parser.add_argument("--doc_stride", type=int, default=128,
                        help="Sliding-window stride for request chunking.")
    parser.add_argument("--long_scatter_chunks", type=int, default=0,
                        help="Long-request scatter threshold: a request "
                             "whose document windows into at least this "
                             "many chunks bypasses deadline coalescing and "
                             "launches its chunks chunk-parallel as "
                             "dedicated batches (BucketGrid.scatter_plan) "
                             "— a whole book answers in one POST /v1/qa "
                             "call. 0 disables the path.")

    # flags of the JAX package whose subsystems are not ported yet: parsed
    # with the same names and defaults, held by check_serve_flags
    parser.add_argument("--mesh", type=cast2(str), default=None,
                        help="Device mesh axes (not ported: one device).")
    parser.add_argument("--autotune", type=_str2bool, default=True,
                        help="Kernel-geometry autotuner (not ported; "
                             "accepted and ignored).")
    parser.add_argument("--autotune_cache", type=cast2(str), default=None,
                        help="Tuning-cache directory (not ported; ignored).")
    parser.add_argument("--aot_cache", type=cast2(str), default=None,
                        help="AOT compiled-program store (not ported; "
                             "ignored).")
    parser.add_argument("--aot_cache_bytes", type=cast_bytes, default=0,
                        help="AOT store byte budget (not ported; ignored).")
    parser.add_argument("--hbm_preflight", type=_str2bool, default=True,
                        help="Per-bucket device-memory pre-flight at warmup "
                             "(not ported; accepted and ignored).")
    parser.add_argument("--serve_cache_bytes", type=cast_bytes, default=0,
                        help="Tier-2 chunk-result cache byte budget (not "
                             "ported: only 0 is accepted).")
    parser.add_argument("--doc_cache_bytes", type=cast_bytes, default=0,
                        help="Tier-1 document-preprocessing cache byte "
                             "budget (not ported: only 0 is accepted).")
    parser.add_argument("--quantize", type=str, default="off",
                        choices=["off", "int8"],
                        help="Serving precision: 'off' serves the compute "
                             "dtype; 'int8' is not ported yet.")

    parser.add_argument("--ready_file", type=cast2(str), default=None,
                        help="Write {host, port, pid} JSON here once the "
                             "listener is up (supervisor / test "
                             "orchestration hook).")

    parser.add_argument("--trace_spans", type=cast2(str), default=None,
                        help="Serving trace spans directory (not ported: "
                             "only None is accepted).")

    return parser


# serve-side flags with no port counterpart that change no result: accepted
# at any value and logged once
_IGNORED_SERVE_FLAGS = ("autotune", "autotune_cache", "aot_cache",
                        "aot_cache_bytes", "hbm_preflight")


def _not_ported(flag: str, value, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"--{flag} {value} is not ported to ml_recipe_tpu_torch yet "
        f"(ROADMAP.md {item})")


def check_serve_flags(params, model_params) -> None:
    """Refuse flags whose subsystem the port lacks and which would change
    results away from their defaults; log the ignored ones once."""
    checks = [
        (params.quantize != "off", "quantize", params.quantize,
         "queue 2, '_q8_matmul_kernel' and queue 1, 'Serving'"),
        (params.mesh is not None, "mesh", params.mesh,
         "queue 1, 'Parallelism beyond data parallelism'"),
        (params.serve_cache_bytes > 0, "serve_cache_bytes",
         params.serve_cache_bytes, "queue 1, 'Serving'"),
        (params.doc_cache_bytes > 0, "doc_cache_bytes",
         params.doc_cache_bytes, "queue 1, 'Serving'"),
        (params.trace_spans is not None, "trace_spans", params.trace_spans,
         "queue 1, 'Serving'"),
        (model_params.flash_attention == "ring", "flash_attention", "ring",
         "queue 1, 'Parallelism beyond data parallelism'"),
        (model_params.ln_impl not in (None, "xla"), "ln_impl",
         model_params.ln_impl, "queue 2, '_ln_fwd_kernel'"),
        (model_params.hf_checkpoint is not None, "hf_checkpoint",
         model_params.hf_checkpoint, "queue 1, 'Training'"),
    ]
    for bad, flag, value, item in checks:
        if bad:
            raise _not_ported(flag, value, item)
    ignored = [f"--{f} {getattr(params, f)}" for f in _IGNORED_SERVE_FLAGS]
    if model_params.remat:
        ignored.append("--remat")
    logger.info("Accepted but not ported (no effect in ml_recipe_tpu_torch): "
                "%s.", ", ".join(ignored))

