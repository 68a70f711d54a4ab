#!/usr/bin/env bash
# Per-rank launcher of the PyTorch/CUDA port's trainer
# (ml_recipe_tpu_torch.cli.train): the reference's environment contract
# MASTER_IP/MASTER_PORT/LOCAL_RANK/WORLD_SIZE mapped onto the CLI's flags,
# as scripts/worker.sh maps it for the JAX package. MASTER_IP=0 resolves to
# this host's name (rank 0 serves the rendezvous itself).
#
# One process per rank joins torch.distributed at
# tcp://MASTER_IP:MASTER_PORT. --dist_backend is not set here: pass it in
# the arguments, or the port's default stands (NCCL on the card, gloo on
# the CPU with --device cpu). Before that, the native qacoord helper runs a
# readiness handshake on MASTER_PORT + 1 so workers block until the
# coordinator is reachable instead of failing on a TCP connect.
#
# With --mesh data:D,seq:S in the arguments (or a cfg's mesh=, such as
# config/longdoc.cfg's data:1,seq:2) WORLD_SIZE is D*S: the flag passes
# through to the CLI, which lays the ranks out on the mesh.
set -euo pipefail

LOCAL_RANK="${LOCAL_RANK:-0}"
WORLD_SIZE="${WORLD_SIZE:-1}"
MASTER_PORT="${MASTER_PORT:-9080}"
MASTER_IP="${MASTER_IP:-0}"

if [ "$MASTER_IP" = "0" ]; then
    MASTER_IP="$(hostname)"
fi

REPO_ROOT="$(cd "$(dirname "${BASH_SOURCE[0]}")/.." && pwd)"
QACOORD="${REPO_ROOT}/native/build/qacoord"
READY_PORT=$((MASTER_PORT + 1))

# a fresh checkout has no native/build/: build the helpers in place when
# g++ is there (seconds; training proceeds without them otherwise)
if [ ! -x "$QACOORD" ] && command -v g++ >/dev/null 2>&1; then
    make -C "$REPO_ROOT/native" >/dev/null 2>&1 || true
fi

if [ "$WORLD_SIZE" -gt 1 ] && [ -x "$QACOORD" ]; then
    if [ "$LOCAL_RANK" = "0" ]; then
        # the readiness barrier runs in the background while rank 0 starts;
        # torch.distributed's own rendezvous finishes the job
        "$QACOORD" serve "$READY_PORT" "$WORLD_SIZE" 600 &
    else
        "$QACOORD" wait "$MASTER_IP" "$READY_PORT" 600 "$LOCAL_RANK" || true
    fi
fi

# the package is importable from any working directory
export PYTHONPATH="${REPO_ROOT}${PYTHONPATH:+:${PYTHONPATH}}"
exec python -m ml_recipe_tpu_torch.cli.train \
    --local_rank "$LOCAL_RANK" \
    --dist_world_size "$WORLD_SIZE" \
    --dist_init_method "tcp://${MASTER_IP}:${MASTER_PORT}" \
    "$@"
