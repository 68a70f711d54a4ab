"""Layered file+CLI config system (the port of ``ml_recipe_tpu/config/parser.py``).

``key = value`` config files are pre-parsed into defaults, and keys a parser
does not know come back from ``parse_known_args`` so ``get_params`` can
route one cfg file to several parsers and fail only on keys no parser
knows. The model, trainer, predictor and serve parsers carry the JAX
package's flags, so ``config/serve.cfg``, ``config/test_bert.cfg`` and
``config/validate.cfg`` parse unchanged, plus flags of the port's own:
``--device`` (``cuda`` by default; ``cpu`` only when asked for) and the
predictor's ``--mesh``.

:func:`check_predict_flags`, :func:`check_serve_flags` and
:func:`check_train_flags` hold the entry points to what the port
implements: a flag whose subsystem is not ported
yet and which would change results at a non-default value raises
``NotImplementedError`` naming its ROADMAP.md item; flags with no port
counterpart that change no result are accepted and logged once as not
ported.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from pathlib import Path
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from ..models.config import MODEL_PRESETS

logger = logging.getLogger(__name__)


def cast2(type_):
    """'None'-string-aware cast (reference parser.py:34-35)."""
    return lambda x: type_(x) if x != "None" else None


def _str2bool(value: str) -> bool:
    return str(value).strip().lower() in ("1", "true", "yes", "on")


def cast_prefetch(value):
    """Device-prefetch depth domain: an int depth, or 'auto'."""
    if str(value).strip().lower() == "auto":
        return "auto"
    return int(value)


def cast_loss_scale(value: str):
    """'None' -> None, 'dynamic' -> 'dynamic', anything else -> float
    (apex's loss_scale flag domain)."""
    if value == "None":
        return None
    if value == "dynamic":
        return "dynamic"
    return float(value)


MESH_HELP = (
    "Device mesh axes as 'name:size' pairs, e.g. 'data:8', "
    "'data:4,model:2', 'data:2,seq:4', or 'data:2,pipe:2' (the port's "
    "trainer runs 'data', 'seq' and 'pipe' axes, one process per device; "
    "its serving and validation run one device)."
)


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

    def serialize(self, config_items: dict) -> str:
        return "".join(f"{key} = {value}\n" for key, value in config_items.items())

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


def write_config_file(parser: ConfigArgumentParser, parsed_namespace,
                      output_path) -> None:
    """Serialize the effective config into the experiment dir."""
    config_items = {
        k: getattr(parsed_namespace, k)
        for k in sorted(parsed_namespace.__dict__.keys())
        if "config" not in k
    }
    with open(output_path, "w") as output_file:
        output_file.write(parser.serialize(config_items))
    logger.info(f"Config was saved to {output_path}.")


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
                             "or ring (sequence-parallel over the mesh's "
                             "seq axis; auto resolves to it there).")
    parser.add_argument("--remat", action="store_true",
                        help="Recompute each encoder layer in the backward "
                             "(torch.utils.checkpoint, replaying its dropout "
                             "draws) to trade FLOPs for device memory.")
    parser.add_argument("--ln_impl", type=cast2(str), default="xla",
                        choices=[None, "xla", "fused", "auto", "interpret"],
                        help="LayerNorm implementation: xla (default, flax "
                             "nn.LayerNorm numerics), fused (the LayerNorm "
                             "kernels on CUDA, their plain version on the "
                             "CPU), auto (the kernels where they take the "
                             "call). interpret has no counterpart in the "
                             "port and is refused.")
    parser.add_argument("--device", type=str, default="cuda",
                        help="Port only: torch device of the model. The "
                             "default needs CUDA and never falls back to the "
                             "CPU; pass 'cpu' to run there on purpose.")

    return parser


def init_base_arguments(parser: ConfigArgumentParser) -> None:
    parser.add_argument("-c", "--config_file", required=False, is_config_file=True,
                        help="Config file path.")

    parser.add_argument("--data_path", type=str, default=None,
                        help="Path to JSON with documents.")
    parser.add_argument("--processed_data_path", type=str, default=None,
                        help="Path where processed dataset will be saved.")

    parser.add_argument("--gpu", action="store_true",
                        help="Accepted for reference-config compatibility; the "
                             "port's device is --device.")

    parser.add_argument("--max_seq_len", type=int, default=384, help="Max input seq length.")
    parser.add_argument("--max_question_len", type=int, default=64, help="Max question length.")
    parser.add_argument("--doc_stride", type=int, default=128,
                        help="Step size during doc splitting.")

    parser.add_argument("--split_by_sentence", action="store_true",
                        help="Split document by sentence instead.")
    parser.add_argument("--truncate", action="store_true",
                        help="Cut off long sentences during splitting by sentence.")

    parser.add_argument("--n_jobs", type=int, default=16,
                        help="Number of host-side data pipeline workers.")


def get_trainer_parser() -> ConfigArgumentParser:
    parser = ConfigArgumentParser(description="Trainer config parser.", add_help=False)
    init_base_arguments(parser)

    parser.add_argument("--trainer_config_file", required=False, is_config_file=True,
                        help="Trainer config file path.")

    parser.add_argument("--dump_dir", type=Path, default=Path("./results"), help="Dump path.")
    parser.add_argument("--experiment_name", type=str, default="test", help="Experiment name.")

    parser.add_argument("--last", type=cast2(str), default=None, help="Restored checkpoint.")

    parser.add_argument("--seed", type=cast2(int), default=None, help="Seed for random state.")

    parser.add_argument("--n_epochs", type=int, default=10, help="Number of epochs.")

    parser.add_argument("--train_batch_size", type=int, default=128,
                        help="Global number of items in an optimizer-step batch.")
    parser.add_argument("--test_batch_size", type=int, default=16,
                        help="Number of items in batch.")
    parser.add_argument("--batch_split", type=int, default=1,
                        help="Micro-batch count for gradient accumulation "
                             "(lax.scan inside the jitted step).")

    parser.add_argument("--lr", type=float, default=1e-5, help="Learning rate for optimizer.")
    parser.add_argument("--weight_decay", type=float, default=0.01,
                        help="Weight decay for optimizer.")

    parser.add_argument("--clear_processed", action="store_true",
                        help="Clear previous processed dataset.")

    parser.add_argument("--w_start", type=float, default=1,
                        help="Weight of start position classification.")
    parser.add_argument("--w_end", type=float, default=1,
                        help="Weight of end position classification.")
    parser.add_argument("--w_start_reg", type=float, default=0,
                        help="Weight of start position regression loss.")
    parser.add_argument("--w_end_reg", type=float, default=0,
                        help="Weight of end position regression loss.")
    parser.add_argument("--w_cls", type=float, default=1,
                        help="Weight of doc label classification.")

    parser.add_argument("--loss", type=str, default="ce", choices=["ce", "focal", "smooth"],
                        help="Type of doc label classification loss")

    parser.add_argument("--smooth_alpha", type=float, default=0.01,
                        help="Smooth CE loss parameter.")
    parser.add_argument("--focal_alpha", type=float, default=1, help="Focal loss parameter.")
    parser.add_argument("--focal_gamma", type=float, default=2, help="Focal loss parameter.")

    parser.add_argument("--max_grad_norm", type=float, default=1,
                        help="Max global norm of the gradients")
    parser.add_argument("--optimizer_sharding", type=cast2(str), default=None,
                        choices=[None, "off", "zero1"],
                        help="Optimizer-state layout: 'zero1' shards every "
                             "AdamW/AdaMod state leaf over the mesh data "
                             "axis (padding-aware per-leaf specs; memory "
                             "~1/N per chip) and runs the weight update on "
                             "each replica's shard only — grads reduce-"
                             "scatter, updated params all-gather back "
                             "replicated. 'off' replicates the full state "
                             "per chip (historical layout; 1-chip zero1 is "
                             "bit-identical to off). Default defers to the "
                             "legacy --shard_optimizer boolean.")
    parser.add_argument("--shard_optimizer", action="store_true",
                        help="Legacy alias of --optimizer_sharding zero1 "
                             "(kept for existing configs): shard optimizer "
                             "moments over the mesh data axis (memory 1/N; "
                             "XLA all-gathers the sharded updates). The "
                             "reference replicates optimizer state per "
                             "process.")
    parser.add_argument("--pipe_schedule", type=cast2(str), default="gpipe",
                        choices=["gpipe", "1f1b"],
                        help="Pipeline tick schedule when --mesh has a pipe "
                             "axis > 1: 'gpipe' (default) keeps all "
                             "batch_split micro-batch activations resident "
                             "through the forward sweep; '1f1b' interleaves "
                             "one-forward-one-backward so at most "
                             "min(batch_split, 2K-1) stage inputs stay "
                             "resident (the port holds at most K stage "
                             "inputs). Both schedules accumulate the same "
                             "gradients in the same order; inert without a "
                             "pipe axis.")
    parser.add_argument("--pipe_param_sharding", type=cast2(str),
                        default="auto",
                        choices=["auto", "stage", "replicated"],
                        help="Pipeline parameter/optimizer storage: 'stage' "
                             "keeps each pipe rank holding ONLY its own "
                             "stage's weights and moments, 'replicated' "
                             "keeps every weight on every rank (each stage "
                             "broadcasts its updated weights over the pipe "
                             "axis after each step), 'auto' (default) picks "
                             "'stage' whenever the pipe axis is > 1.")
    parser.add_argument("--zero1_overlap", type=cast2(str), default="off",
                        choices=["off", "bucketed"],
                        help="ZeRO-1 collective overlap: 'bucketed' splits "
                             "the flat gradient accumulation into "
                             "size-targeted contiguous buckets so each "
                             "bucket's reduce-scatter / all-gather is "
                             "independently schedulable and hides under "
                             "the remaining backward/update compute, "
                             "instead of one fused tail exchange. Same "
                             "arithmetic (trajectories agree to GSPMD "
                             "reduction-order tolerance); 'off' (default) "
                             "keeps the monolithic exchange verbatim. "
                             "Inert without an active zero1 layout.")
    parser.add_argument("--zero1_bucket_mb", type=float, default=4.0,
                        help="Bucketed ZeRO-1 overlap: target f32 payload "
                             "per gradient bucket in MB (a single larger "
                             "leaf gets its own bucket; small leaves "
                             "coalesce).")
    parser.add_argument("--async_checkpoint", action="store_true",
                        help="Async overlapped checkpointing: saves block "
                             "only for the device-to-host snapshot; the "
                             "serialize+write persist runs on a background "
                             "thread with the same per-leaf crc32 and "
                             "atomic-rename discipline, a completion "
                             "barrier before the next save / restore / "
                             "exit / SIGTERM resume, and the previous "
                             "valid checkpoint staying newest if a crash "
                             "lands mid-persist. Saved bytes are identical "
                             "to a sync save of the same step.")
    parser.add_argument("--sharded_checkpoint", action="store_true",
                        help="Checkpoint saves write a per-process sharded "
                             "directory (each host saves only the array "
                             "shards it owns) instead of gathering the full "
                             "state for one single-file write. Restore "
                             "auto-detects either layout and works across "
                             "topology changes (save at world N, restore at "
                             "world M), but reassembles the full state on "
                             "each host — the no-gather memory bound applies "
                             "to saves only.")
    parser.add_argument("--sync_bn", action="store_true",
                        help="Cross-replica normalization statistics sync (reference "
                             "SyncBN flag; BERT has LayerNorm so this is a no-op "
                             "unless BatchNorm layers are present).")

    parser.add_argument("--warmup_coef", type=float, default=0.05, help="Warmup coefficient.")

    # Padding-free input pipeline (data/bucketing.py + data/device_prefetch.py).
    parser.add_argument("--length_buckets", type=str, default="off",
                        help="Length-bucketed token-budget batching: 'off' "
                             "(pad every batch to max_seq_len — historical "
                             "behavior), 'auto' (evenly spaced seq grid "
                             "ending at max_seq_len, e.g. 128,256,384,512), "
                             "or explicit comma-separated seq edges. Batches "
                             "pad to their BUCKET and the per-bucket batch "
                             "size scales inversely with seq (constant "
                             "token budget per step); one compiled program "
                             "per occupied bucket. Single-process only.")
    parser.add_argument("--sequence_packing", type=str, default="off",
                        help="Sequence packing (data/packing.py): "
                             "concatenate short chunks into full "
                             "max_seq_len rows with block-diagonal "
                             "attention and per-segment heads — ~every "
                             "token real, ONE compiled train program "
                             "(vs one per bucket). 'off' (default) keeps "
                             "the bucketed/padded path bit-exactly; 'on' "
                             "enables it and supersedes --length_buckets. "
                             "Multi-process runs derive every process's "
                             "pack plan from the shared length oracle.")
    parser.add_argument("--pack_max_segments", type=int, default=8,
                        help="Sequence packing: max chunks packed into one "
                             "row (the static S of the per-segment label "
                             "planes and head outputs).")
    parser.add_argument("--pack_splitting", type=str, default="off",
                        help="Hole-filling chunk splitting for the packer: "
                             "'off' (default — the non-splitting packer, "
                             "bit-identical to before) or 'fill' (a chunk "
                             "that fits no open row is split at a "
                             "label-safe token boundary — never through "
                             "the gold answer span — and its head "
                             "fragment fills the largest residual hole; "
                             "the span-bearing fragment keeps the labels, "
                             "siblings are ignore-indexed). Breaks the "
                             "~1.6%% waste floor of quantized chunk mixes.")
    parser.add_argument("--pack_min_fragment", type=int, default=32,
                        help="Splitting packer: minimum fragment size in "
                             "tokens (no head or tail fragment goes below "
                             "this — avoids degenerate few-token "
                             "segments).")
    parser.add_argument("--device_prefetch", type=cast_prefetch, default=0,
                        help="Double-buffered device prefetch depth: keep "
                             "this many placed global batches in flight on "
                             "a background thread so the host->device copy "
                             "of step k+1 overlaps compute of step k. 0 = "
                             "synchronous placement (historical behavior); "
                             "2 is the intended on-chip setting; 'auto' "
                             "times the first few steps of epoch 1 and "
                             "picks depth 1 vs 2, logging the choice. The "
                             "trajectory is bit-identical at any depth.")
    parser.add_argument("--log_every", type=int, default=10,
                        help="Steps between tqdm-postfix/TensorBoard writes "
                             "in the train loop (meters still update every "
                             "step; the epoch's final state is always "
                             "written).")

    # The warm-up plane (cli/train.py): the tuning cache, the store of
    # built kernel libraries and the measured memory pre-flight.
    parser.add_argument("--autotune", type=_str2bool, default=True,
                        help="Tuning cache (ops/autotune.py): configured "
                             "from this flag; every kernel of the port has "
                             "one compiled geometry, so training records "
                             "nothing in it.")
    parser.add_argument("--autotune_cache", type=cast2(str), default=None,
                        help="Directory of the tuning cache (default "
                             "artifacts/tuning/, or $MLRT_AUTOTUNE_CACHE).")
    parser.add_argument("--aot_cache", type=cast2(str), default=None,
                        help="Store of built kernel libraries (ops/aot.py): "
                             "'off' builds every library in this process, "
                             "a path overrides the store directory "
                             "(default ml_recipe_tpu_torch/csrc/build/, or "
                             "$MLRT_AOT_CACHE). A warm restart loads its "
                             "libraries instead of building them.")
    parser.add_argument("--aot_cache_bytes", type=cast_bytes, default=0,
                        help="Byte budget for the library store (K/M/G "
                             "suffixes); oldest artifacts are evicted past "
                             "it. 0 = unbounded.")
    parser.add_argument("--hbm_preflight", type=_str2bool, default=True,
                        help="Before the first train step, run one forward "
                             "and backward at the micro-batch shape and "
                             "measure its device memory; if the step "
                             "exceeds the card's memory, raise batch_split "
                             "(logged with before/after byte counts) "
                             "instead of running out of memory.")

    # Mixed precision: native policy + accepted Apex aliases.
    parser.add_argument("--precision", type=cast2(str), default=None,
                        choices=[None, "f32", "bf16"],
                        help="Mixed-precision policy. None defers to apex_level mapping.")
    parser.add_argument("--apex_level", type=cast2(str),
                        choices=[None, "O0", "O1", "O2", "O3"], default=None,
                        help="Reference-compat alias: O1/O2/O3 -> bf16, O0/None -> f32.")
    parser.add_argument("--apex_verbosity", type=int, default=1,
                        help="Accepted for config compatibility.")
    parser.add_argument("--apex_loss_scale", type=cast_loss_scale, default=None,
                        help="Loss scale: a number for static, 'dynamic' for "
                             "apex-style dynamic scaling (halve on overflow, "
                             "double after 2000 finite steps, update skipped "
                             "on overflow). bf16 normally needs none.")

    parser.add_argument("--drop_optimizer", action="store_true",
                        help="Not restore optimizer and scheduler from checkpoint.")

    parser.add_argument("--debug", action="store_true", help="Debug mode.")
    parser.add_argument("--trace", action="store_true",
                        help="Capture train steps 2-4 of epoch 1 (from step "
                             "0 in debug runs) with torch.profiler, CPU and "
                             "CUDA activity, as a Chrome trace into "
                             "<dump_dir>/board/<experiment>/trace (view in "
                             "Perfetto).")
    parser.add_argument("--dummy_dataset", action="store_true",
                        help="Use generated dataset instead real data.")

    # Distributed: the reference's names, torch.distributed underneath
    # (parallel/dist.py).
    parser.add_argument("--local_rank", type=int, default=-1,
                        help="Rank of this process (0 .. dist_world_size-1); "
                             "it runs on cuda:(rank %% device count) unless "
                             "--device names an index.")
    parser.add_argument("--dist_backend", type=str, default="xla", choices=["xla", "nccl"],
                        help="Process-group backend: 'xla' (the JAX package's "
                             "default) is NCCL on CUDA and gloo on the CPU; "
                             "'nccl' is NCCL.")
    parser.add_argument("--dist_init_method", type=str, default="tcp://127.0.0.1:9080",
                        help="Rendezvous address, tcp://HOST:PORT (rank 0 "
                             "listens there).")
    parser.add_argument("--dist_world_size", type=int, default=1,
                        help="Number of data-parallel processes, one per GPU "
                             "(or on the CPU with --device cpu).")
    parser.add_argument("--mesh", type=cast2(str), default=None,
                        help=MESH_HELP)

    # Fault tolerance (resilience/): supervised restart + watchdog + drills.
    parser.add_argument("--supervise", action="store_true",
                        help="Wrap the run in the auto-resume supervisor: "
                             "restart on preemption/hang/crash with "
                             "exponential backoff, resume from the newest "
                             "valid checkpoint, abort on a crash-loop.")
    parser.add_argument("--max_restarts", type=int, default=5,
                        help="Supervisor: restarts after the first attempt.")
    parser.add_argument("--backoff_base", type=float, default=1.0,
                        help="Supervisor: seconds before the first restart "
                             "(doubles per restart, seeded +-10%% jitter).")
    parser.add_argument("--backoff_max", type=float, default=30.0,
                        help="Supervisor: backoff ceiling in seconds.")
    parser.add_argument("--crash_loop_window", type=int, default=3,
                        help="Supervisor: abort with a diagnosis after this "
                             "many consecutive failed attempts with no "
                             "global_step progress.")
    parser.add_argument("--watchdog_timeout", type=cast2(float), default=None,
                        help="Seconds a train/eval step or checkpoint "
                             "barrier may take before the watchdog dumps "
                             "all-thread stacks and aborts for restart. "
                             "None disables. Must comfortably exceed the "
                             "first (compiling) step.")
    parser.add_argument("--fault_plan", type=cast2(str), default=None,
                        help="Fault-injection drill spec, e.g. "
                             "'ckpt.pre_manifest:kill@2!once;"
                             "loader.read:raise@1x3' "
                             "(see resilience/faults.py for the grammar, "
                             "including %%hostN host scoping; "
                             "also via $MLRT_FAULTS).")
    parser.add_argument("--elastic", type=cast2(str), default="off",
                        choices=["off", "on"],
                        help="Elastic pod supervision (with --supervise): "
                             "per-host supervisors coordinate through "
                             "<exp_dir>/pod/ heartbeat files — a dead "
                             "host's peers kill+restart their children "
                             "immediately and resume on a re-derived "
                             "smaller mesh (data axis shrinks; pipe/seq/"
                             "model refuse). Default off: fixed-world "
                             "supervision, byte-identical to before.")
    parser.add_argument("--min_world", type=int, default=1,
                        help="Elastic: abort (instead of shrinking further) "
                             "when fewer live hosts remain — training "
                             "degenerately narrow burns budget silently.")
    parser.add_argument("--host_timeout", type=float, default=60.0,
                        help="Elastic: seconds a peer host's heartbeat may "
                             "age before it is declared lost and the pod "
                             "restarts without it.")
    parser.add_argument("--coord_poll", type=float, default=2.0,
                        help="Elastic: seconds between coordination sweeps "
                             "(heartbeat publish + peer reads) while the "
                             "child runs.")

    # Observability plane (metrics/ + train/telemetry.py): everything off
    # by default — the off path is pinned bit-identical.
    parser.add_argument("--metrics_port", type=cast2(int), default=None,
                        help="Serve the training-plane Prometheus registry "
                             "at http://0.0.0.0:<port>/metrics (+ /healthz) "
                             "from a daemon thread: per-step wall-time "
                             "breakdown (data wait / host / device), "
                             "tokens/sec, padding waste, checkpoint "
                             "durations, watchdog heartbeat age, supervisor "
                             "restart counts. 0 binds an ephemeral port "
                             "(logged); None (default) disables. Multi-host "
                             "runs add the process index to the port so "
                             "each host exports its own plane.")
    parser.add_argument("--trace_spans", type=cast2(str), default=None,
                        help="Write structured host trace spans (loader -> "
                             "place/H2D -> step -> checkpoint) as Chrome "
                             "trace-event JSON into this directory — load "
                             "in Perfetto. Composes with --trace: the "
                             "profiler window's boundaries are marked in "
                             "the span stream. None (default) disables.")
    parser.add_argument("--anomaly_factor", type=float, default=3.0,
                        help="Slow-step detector (active with "
                             "--metrics_port): a step slower than this "
                             "factor times the rolling median step time "
                             "logs one structured WARNING with the "
                             "breakdown attribution and increments "
                             "train_slow_steps_total.")
    parser.add_argument("--anomaly_window", type=int, default=64,
                        help="Slow-step detector: rolling window size "
                             "(steps) for the median+MAD baseline.")
    parser.add_argument("--goodput_ledger", action="store_true",
                        help="Keep the run-level goodput ledger "
                             "(goodput.jsonl next to supervisor_state.json "
                             "in the experiment dir): an append-only event "
                             "log partitioning total run wall-clock into "
                             "productive step time vs named badput "
                             "(compile/warmup, data wait, checkpoint "
                             "save/restore, eval, restart downtime, "
                             "recomputed steps), summarized at run end and "
                             "exported as train_goodput_ratio + "
                             "train_badput_seconds_total{category=...}. "
                             "Survives supervised restarts. Off by "
                             "default.")
    parser.add_argument("--flight_recorder", action="store_true",
                        help="Arm the crash flight recorder: a bounded "
                             "ring of the last N structured events (step "
                             "breakdown, anomaly verdicts, checkpoint "
                             "events, loss-scale adjustments) dumped "
                             "atomically to a timestamped JSON in the "
                             "experiment dir on crash, watchdog abort, "
                             "SIGTERM and periodically — the supervisor's "
                             "crash-loop diagnosis reads the newest dump "
                             "back. Off by default.")
    parser.add_argument("--flightrec_events", type=int, default=256,
                        help="Flight recorder: ring capacity (events kept "
                             "in the crash dump).")
    parser.add_argument("--metrics_hosts", type=cast2(str), default=None,
                        help="Comma-separated host:port list of every "
                             "host's /metrics exporter. Process 0 then "
                             "serves the pod-scope merged page (sum/min/"
                             "max + per-host views, slowest-host and "
                             "step-time-skew gauges) at /metrics/pod on "
                             "its own exporter. Requires --metrics_port. "
                             "None (default) disables.")

    parser.add_argument("--best_metric", choices=["map"], type=str, default="map",
                        help="Best metric name.")
    parser.add_argument("--best_order", choices=[">", "<"], type=str, default=">",
                        help="Best metric order.")

    parser.add_argument("--finetune", action="store_true", help="Turn on finetune mode.")
    parser.add_argument("--finetune_transformer", action="store_true",
                        help="Finetune transformer module.")
    parser.add_argument("--finetune_position", action="store_true",
                        help="Finetune classification head.")
    parser.add_argument("--finetune_position_reg", action="store_true",
                        help="Finetune regression head.")
    parser.add_argument("--finetune_class", action="store_true",
                        help="Finetune doc label classification head.")

    parser.add_argument("--bpe_dropout", type=cast2(float), default=None, help="Use BPE dropout.")

    parser.add_argument("--optimizer", type=str, default="adam", choices=["adam", "adamod"],
                        help="Optimizer name.")

    parser.add_argument("--train_label_weights", action="store_true",
                        help="Use label weights in CE loss.")
    parser.add_argument("--train_sampler_weights", action="store_true",
                        help="Use oversampling.")

    parser.add_argument("--log_file", type=str, default=None,
                        help="This parameter is ignored. After dump will consist "
                             "path to log file.")

    parser.add_argument("--device", type=str, default="cuda",
                        help="Port only: torch device of the run. The default "
                             "needs CUDA and never falls back to the CPU; pass "
                             "'cpu' to run there on purpose.")

    return parser


def get_predictor_parser() -> ConfigArgumentParser:
    """Offline-eval config (``cli.validate``, ``cli.train_metrics``): the JAX
    package's flags and defaults, plus ``--mesh`` (held by
    :func:`check_predict_flags`)."""
    parser = ConfigArgumentParser(description="Validation config parser.", add_help=False)
    init_base_arguments(parser)

    parser.add_argument("--predictor_config_file", required=False, is_config_file=True,
                        help="Predictor config file path.")

    parser.add_argument("--checkpoint", type=cast2(str), default=None,
                        help="Restored checkpoint path.")

    parser.add_argument("--batch_size", type=int, default=16, help="Batch size.")
    parser.add_argument("--buffer_size", type=int, default=4096, help="Buffer queue size.")

    parser.add_argument("--limit", type=cast2(int), default=None,
                        help="Stop after batch number LIMIT, counted from 0 "
                             "(LIMIT + 1 batches, as the JAX predictor "
                             "counts); None scores every chunk.")

    parser.add_argument("--fetch_every", type=int, default=1,
                        help="Accepted for reference-config compatibility; "
                             "no effect: the port copies each batch's "
                             "output to the host on its own.")

    parser.add_argument("--gpu_compat", action="store_true",
                        help="Accepted for reference-config compatibility.")

    parser.add_argument("--length_buckets", type=str, default="off",
                        help="Length-bucketed chunk batching for offline "
                             "eval: 'off', 'auto', or comma-separated seq "
                             "edges (see the trainer flag). Chunks pad to "
                             "their bucket instead of max_seq_len; the "
                             "per-bucket batch size holds the token budget "
                             "batch_size * max_seq_len constant.")
    parser.add_argument("--sequence_packing", type=str, default="off",
                        help="Sequence packing for offline eval: 'on' "
                             "first-fits chunks into full max_seq_len rows "
                             "with block-diagonal attention and scores each "
                             "chunk per segment; supersedes "
                             "--length_buckets.")
    parser.add_argument("--pack_max_segments", type=int, default=8,
                        help="Sequence packing: max chunks per packed row "
                             "(the static S of the per-segment outputs).")
    parser.add_argument("--pack_splitting", type=str, default="off",
                        help="Hole-filling chunk splitting for packed "
                             "offline eval: 'off' or 'fill' (fragments "
                             "re-merged into per-chunk outputs).")
    parser.add_argument("--pack_min_fragment", type=int, default=32,
                        help="Splitting packer: minimum fragment size in "
                             "tokens.")

    parser.add_argument("--quantize", type=str, default="off",
                        choices=["off", "int8"],
                        help="Post-training quantization for offline eval "
                             "(cli.validate only): 'int8' converts the "
                             "restored float checkpoint to per-channel int8 "
                             "and scores through the int8 matmul kernel, the "
                             "serving engine's conversion.")
    parser.add_argument("--mesh", type=cast2(str), default=None,
                        help="Device mesh axes (not ported: one device; a "
                             "mesh of one device is accepted).")

    return parser


# the ROADMAP item inference over a mesh (the model axis included) waits for
_INFERENCE = ("queue 1, 'Parallelism beyond data parallelism', item "
              "'Inference over a mesh'")


def _mesh_devices(spec) -> int:
    """Device count of a ``name:size,...`` mesh spec (1 for None)."""
    if spec is None:
        return 1
    count = 1
    for part in str(spec).split(","):
        if part.strip():
            count *= int(part.split(":")[-1])
    return count


def check_predict_flags(params, model_params) -> None:
    """Refuse predictor flags whose subsystem the port lacks: a ``--mesh``
    of more than one device and ring attention. ``--fetch_every`` is
    accepted and logged: the port copies each batch's output on its own."""
    _check_ln_impl(model_params)
    if params.fetch_every != 1:
        logger.info("Accepted but not ported (no effect in "
                    "ml_recipe_tpu_torch): --fetch_every %s.",
                    params.fetch_every)
    checks = [
        (_mesh_devices(params.mesh) > 1, "mesh", params.mesh, _INFERENCE),
        (model_params.flash_attention == "ring", "flash_attention", "ring",
         _INFERENCE),
    ]
    for bad, flag, value, item in checks:
        if bad:
            raise _not_ported(flag, value, item)


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
                        help="Tuning cache of measured bucket costs "
                             "(ops/autotune.py): warmup times each bucket's "
                             "program once per cache and deadline flushes "
                             "rank by it, cheapest first; a warm restart "
                             "measures nothing. false keeps oldest-first.")
    parser.add_argument("--autotune_cache", type=cast2(str), default=None,
                        help="Tuning-cache directory (default "
                             "artifacts/tuning/, or $MLRT_AUTOTUNE_CACHE).")
    parser.add_argument("--aot_cache", type=cast2(str), default=None,
                        help="Store of built kernel libraries (ops/aot.py): "
                             "a path overrides its directory (default "
                             "ml_recipe_tpu_torch/csrc/build/, or "
                             "$MLRT_AOT_CACHE); a rolling-restart "
                             "replacement engine loads every library "
                             "instead of building it. 'off' builds every "
                             "library in this process and dispatches every "
                             "batch eagerly instead of through the "
                             "buckets' CUDA graphs.")
    parser.add_argument("--aot_cache_bytes", type=cast_bytes, default=0,
                        help="Byte budget for the library store (K/M/G "
                             "suffixes); oldest artifacts are evicted past "
                             "it. 0 = unbounded.")
    parser.add_argument("--hbm_preflight", type=_str2bool, default=True,
                        help="Per-bucket device-memory pre-flight at "
                             "warmup: one measured forward at each bucket's "
                             "shape, and a bucket that exceeds the card's "
                             "memory is DROPPED instead of running out of "
                             "memory mid-traffic.")
    parser.add_argument("--serve_cache_bytes", type=cast_bytes, default=0,
                        help="Tier-2 chunk-result cache byte budget (K/M/G "
                             "suffixes): per-window output rows keyed by "
                             "the exact device input row, the weights "
                             "fingerprint and the precision, with "
                             "single-flight dedup; a fully-hot request "
                             "never reaches the device. 0 disables it.")
    parser.add_argument("--doc_cache_bytes", type=cast_bytes, default=0,
                        help="Tier-1 document-preprocessing cache byte "
                             "budget (K/M/G suffixes): document tokens and "
                             "windows by content hash. 0 disables it.")
    parser.add_argument("--quantize", type=str, default="off",
                        choices=["off", "int8"],
                        help="Serving precision: 'off' serves the compute "
                             "dtype; 'int8' converts the float weights to "
                             "per-channel int8 at start-up and runs every "
                             "matmul projection through the int8 kernel.")

    parser.add_argument("--ready_file", type=cast2(str), default=None,
                        help="Write {host, port, pid} JSON here once the "
                             "listener is up (supervisor / test "
                             "orchestration hook).")

    parser.add_argument("--trace_spans", type=cast2(str), default=None,
                        help="Write structured request-lifecycle spans "
                             "(admission -> queue -> flush -> device -> "
                             "span_reduce -> respond, keyed by request id) "
                             "as Chrome trace-event JSON into this "
                             "directory, one serve_trace_<pid>.json per "
                             "process, flushed on drain. None (default) "
                             "disables.")

    return parser


def get_fleet_parser() -> ConfigArgumentParser:
    """Serving-fleet config ([fleet] surface): router tier size, ring
    geometry, health-driven shedding thresholds, rolling restarts. The
    fleet CLI composes this with the serve + model parsers — serve flags
    (buckets, caches, drain budget, --host/--port for the ROUTER bind)
    are forwarded to every engine child."""
    parser = ConfigArgumentParser(description="Fleet config parser.", add_help=False)

    parser.add_argument("-c", "--config_file", required=False, is_config_file=True,
                        help="Config file path.")
    parser.add_argument("--fleet_config_file", required=False, is_config_file=True,
                        help="Fleet config file path.")

    parser.add_argument("--engines", type=int, default=2,
                        help="Engine processes behind the router. Each is "
                             "one ml_recipe_tpu_torch.cli.serve child on an "
                             "ephemeral port, loading the kernels the "
                             "checkout has built (csrc/build/).")
    parser.add_argument("--engine_checkpoints", type=cast2(str), default=None,
                        help="Comma list of checkpoint paths assigned "
                             "per-engine (1 entry = every engine, N "
                             "entries = one each — multi-checkpoint A/B "
                             "routing in one tier; the checkpoint-"
                             "fingerprint cache keys isolate results). "
                             "None = every engine uses --checkpoint.")
    parser.add_argument("--ring_replicas", type=int, default=64,
                        help="Virtual nodes per engine on the consistent-"
                             "hash ring (bounded; health weighting scales "
                             "a node's share of them).")
    parser.add_argument("--health_poll_s", type=float, default=1.0,
                        help="Router health-poll interval: every engine's "
                             "/healthz (status + queue depth) is polled "
                             "this often; ejection latency for a dead "
                             "engine is bounded by eject_after polls.")
    parser.add_argument("--eject_after", type=int, default=2,
                        help="Consecutive health failures before an engine "
                             "is ejected from the ring (the first failure "
                             "weight-reduces it to --degrade_weight).")
    parser.add_argument("--degrade_weight", type=float, default=0.25,
                        help="Ring weight of a degraded engine (failing "
                             "polls, 429/503 answers, or queue pressure "
                             "past --queue_pressure).")
    parser.add_argument("--queue_pressure", type=float, default=0.75,
                        help="Queue-depth fraction of an engine's bounded "
                             "queue past which the router weight-reduces "
                             "it (healthy-but-saturated: load is moved, "
                             "no ejection counter advances).")
    parser.add_argument("--spill_retries", type=int, default=1,
                        help="Ring successors to try after the owning "
                             "engine refuses a request (connection error, "
                             "429, 503). Only when every candidate "
                             "refuses does the router shed with 503 + "
                             "Retry-After.")
    parser.add_argument("--routing", type=str, default="hash",
                        choices=["hash", "random"],
                        help="Request routing policy: 'hash' pins each "
                             "document's traffic to one engine via the "
                             "consistent-hash ring (cache affinity), "
                             "'random' scatters uniformly (the bench "
                             "baseline).")
    parser.add_argument("--rolling_restart", type=_str2bool, default=False,
                        help="After the tier is ready, perform one rolling "
                             "restart pass (drain -> relaunch with zero "
                             "kernel builds asserted -> re-admit, one "
                             "engine at a time), then keep serving. "
                             "SIGHUP asks for another pass at any time.")
    parser.add_argument("--fleet_run_dir", type=cast2(str), default=None,
                        help="Directory for engine ready files + logs "
                             "(None = a fresh temp dir).")

    return parser


# the serve-side warm-up plane's flags (cli/serve.py): live, logged once
_WARMUP_FLAGS = ("autotune", "autotune_cache", "aot_cache", "aot_cache_bytes",
                 "hbm_preflight")


def _not_ported(flag: str, value, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"--{flag} {value} is not ported to ml_recipe_tpu_torch yet "
        f"(ROADMAP.md {item})")


def _check_ln_impl(model_params) -> None:
    """``--ln_impl interpret`` runs the JAX package's Pallas kernel in
    interpret mode, a test vehicle with no counterpart in the port."""
    if model_params.ln_impl == "interpret":
        raise ValueError(
            "--ln_impl interpret (Pallas interpret mode) has no counterpart "
            "in ml_recipe_tpu_torch: use fused, which runs the kernels' "
            "plain versions on the CPU")


def check_serve_flags(params, model_params) -> None:
    """Refuse flags whose subsystem the port lacks and which would change
    results away from their defaults; log the ignored ones once."""
    _check_ln_impl(model_params)
    checks = [
        (params.mesh is not None, "mesh", params.mesh, _INFERENCE),
        (model_params.flash_attention == "ring", "flash_attention", "ring",
         _INFERENCE),
    ]
    for bad, flag, value, item in checks:
        if bad:
            raise _not_ported(flag, value, item)
    if model_params.remat:
        logger.info("Accepted but not ported (no effect in "
                    "ml_recipe_tpu_torch): --remat.")
    logger.info("Warm-up plane (live): %s.", ", ".join(
        f"--{f} {getattr(params, f)}" for f in _WARMUP_FLAGS))



# trainer flags with no port counterpart that change no result at any
# value: accepted and logged once
_IGNORED_TRAIN_FLAGS = (
    "gpu", "sync_bn", "apex_level", "apex_verbosity", "precision",
)
# model flags of the same kind: --param_dtype bfloat16 reaches no parameter
# in the JAX package either (flax keeps them f32), so it trains as float32
_IGNORED_MODEL_TRAIN_FLAGS = ("param_dtype",)

# the runtime subsystems' flags and knobs (cli/train.py): live, logged once
_RUNTIME_TRAIN_FLAGS = (
    "trace", "trace_spans", "metrics_port", "metrics_hosts",
    "goodput_ledger", "flight_recorder", "watchdog_timeout", "supervise",
    "fault_plan", "anomaly_factor", "anomaly_window", "flightrec_events",
    "max_restarts", "backoff_base", "backoff_max", "crash_loop_window",
    "elastic", "min_world", "host_timeout", "coord_poll",
    "autotune", "autotune_cache", "aot_cache", "aot_cache_bytes",
    "hbm_preflight",
)


def _world_size_from_env() -> int:
    try:
        return int(os.environ.get("WORLD_SIZE", "1") or 1)
    except ValueError:
        return 1


def check_train_flags(params, model_params) -> None:
    """Refuse trainer flags whose subsystem the port lacks and which would
    change results away from their defaults; log the ignored ones once.

    The world comes from the flags (``--dist_world_size``, ``--local_rank``,
    ``--dist_init_method``), as in the JAX CLI, or from the elastic
    supervisor's world override (``MLRT_ELASTIC_WORLD``, the live world
    after a host loss); a launcher's ``WORLD_SIZE`` > 1 that the flags do
    not repeat raises (``scripts/worker_torch.sh`` maps the environment
    onto the flags). ``--mesh`` takes ``data``, ``seq``, ``pipe`` and
    ``model`` axes whose sizes multiply to the live world (``pipe`` beside
    ``seq`` raises, and so does ``model`` beside ``seq``, and a ``model``
    size that does not divide the heads and the MLP columns; ``model``
    beside ``pipe`` runs, ``pipe:2,model:2`` or ``data:2,pipe:2,model:2``,
    with every flag that each axis takes alone); under
    ``--elastic on`` its ``data`` axis narrows to fit it
    (``parallel.mesh.elastic_axes``). ``--flash_attention ring`` needs a
    ``seq`` axis > 1 (beside a ``model`` axis it raises); ZeRO-1 runs at
    any world and is inert at data size 1, and so is ``--zero1_overlap
    bucketed`` (also on a ``seq`` or ``model`` mesh and under ``pipe``). ``--pipe_schedule`` and
    ``--pipe_param_sharding`` are live with a ``pipe`` axis > 1 and inert
    without one.

    The runtime subsystems are live: ``--trace``, ``--trace_spans``,
    ``--metrics_port``, ``--metrics_hosts``, ``--goodput_ledger``,
    ``--flight_recorder``, ``--watchdog_timeout``, ``--supervise`` and
    ``--fault_plan``, with their knobs ``--anomaly_factor``,
    ``--anomaly_window``, ``--flightrec_events``, ``--max_restarts``,
    ``--backoff_base``, ``--backoff_max`` and ``--crash_loop_window``
    (``cli/train.py``), and so is the warm-up plane: ``--autotune``,
    ``--autotune_cache``, ``--aot_cache``, ``--aot_cache_bytes`` and
    ``--hbm_preflight``, and elastic supervision: ``--elastic`` with
    ``--min_world``, ``--host_timeout`` and ``--coord_poll``."""
    _check_ln_impl(model_params)
    world = int(params.dist_world_size)
    if world < 1 or (world > 1 and not 0 <= params.local_rank < world):
        raise ValueError(f"--dist_world_size {world} needs --local_rank in "
                         f"0..{world - 1}; got {params.local_rank}")
    env_world = _world_size_from_env()
    if env_world > 1 and env_world != world:
        raise ValueError(
            f"WORLD_SIZE={env_world} in the environment, but "
            f"--dist_world_size {world}: launch each rank with "
            f"--dist_world_size/--local_rank/--dist_init_method "
            f"(scripts/worker_torch.sh maps the environment onto them)")
    from ..parallel.dist import live_world
    from ..parallel.mesh import (
        _SEQ_MODEL,
        MeshSpec,
        check_model_split,
        elastic_axes,
        refuse_unported_axes,
    )

    live, _ = live_world(params)
    axes = MeshSpec.from_string(params.mesh, n_devices=live).ordered()
    refuse_unported_axes(axes)
    if axes.get("model", 1) > 1:
        if model_params.flash_attention == "ring":
            raise NotImplementedError(
                "--flash_attention ring beside a model axis: the ring's hops "
                "would have to run the tensor-parallel heads; ROADMAP.md "
                f"{_SEQ_MODEL}")
        from ..models.config import resolve_model_config

        cfg = resolve_model_config(model_params, num_labels=5)
        check_model_split(cfg.num_heads, cfg.intermediate_size,
                          axes["model"])
    if params.elastic == "on":
        axes = elastic_axes(axes, live)
    if MeshSpec(axes).size != live:
        raise ValueError(f"--mesh {params.mesh} needs {MeshSpec(axes).size} "
                         f"processes; the world has {live}")
    if model_params.flash_attention == "ring" and axes.get("seq", 1) < 2:
        raise ValueError("--flash_attention ring needs a 'seq' mesh axis > 1 "
                         "(--mesh 'data:N,seq:M')")
    zero1 = (params.optimizer_sharding == "zero1"
             or (params.optimizer_sharding is None and params.shard_optimizer))
    if zero1 and axes.get("data", 1) < 2:
        # the JAX trainer on a mesh without a data axis to shard over: the
        # ZeRO-1 plan is None and checkpoints record opt_sharding 'off'
        logger.info("--optimizer_sharding zero1 (--shard_optimizer) is inert "
                    "at data axis size 1: the optimizer state stays whole, "
                    "as the JAX trainer keeps it on such a mesh.")
    from ..parallel.pipeline import PIPE_SCHEDULES, resolve_param_layout

    if params.pipe_schedule not in PIPE_SCHEDULES:
        raise ValueError(f"--pipe_schedule must be one of {PIPE_SCHEDULES}, "
                         f"got {params.pipe_schedule!r}")
    resolve_param_layout(params.pipe_param_sharding, axes.get("pipe", 1))
    if axes.get("pipe", 1) > 1:
        logger.info("Pipeline (live): --pipe_schedule %s, "
                    "--pipe_param_sharding %s over pipe:%d.",
                    params.pipe_schedule, params.pipe_param_sharding,
                    axes["pipe"])
    ignored = [f"--{f} {getattr(params, f)}" for f in _IGNORED_TRAIN_FLAGS]
    ignored += [f"--{f} {getattr(model_params, f)}"
                for f in _IGNORED_MODEL_TRAIN_FLAGS]
    logger.info("Accepted but not ported (no effect in ml_recipe_tpu_torch): "
                "%s.", ", ".join(ignored))
    logger.info("Runtime subsystems (live): %s.", ", ".join(
        f"--{f} {getattr(params, f)}" for f in _RUNTIME_TRAIN_FLAGS))
    logger.info("ZeRO-1 overlap (live): --zero1_overlap %s, "
                "--zero1_bucket_mb %s.", params.zero1_overlap,
                params.zero1_bucket_mb)
