#!/usr/bin/env bash
# Multi-host training launcher of the PyTorch port: the counterpart of
# tools/launch_multihost.sh (and of the reference's tools/dist_train.sh /
# tools/slurm_train.sh).  ONE torchrun per host, each starting one process
# per card (--nproc_per_node); the first host's address is the rendezvous
# point.  tools/train_torch.py joins the process group through torchrun's
# RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT, one card per
# local rank, NCCL between them.
#
# Slurm (one task per host; the first node of the allocation coordinates):
#   srun --ntasks="$NUM_HOSTS" --ntasks-per-node=1 \
#     bash tools/launch_torch_multihost.sh --ann-file ... [train_torch.py args]
#
# Manual two-host example, 8 cards each:
#   host0$ FUSIONOCC_COORDINATOR=host0:29500 FUSIONOCC_NUM_HOSTS=2 \
#          FUSIONOCC_HOST_ID=0 bash tools/launch_torch_multihost.sh --synthetic
#   host1$ FUSIONOCC_COORDINATOR=host0:29500 FUSIONOCC_NUM_HOSTS=2 \
#          FUSIONOCC_HOST_ID=1 bash tools/launch_torch_multihost.sh --synthetic
#
# FUSIONOCC_CARDS_PER_HOST sets --nproc_per_node (default: every card the
# host's nvidia-smi lists).
set -euo pipefail

if [[ -n "${SLURM_JOB_NODELIST:-}" ]]; then
  first_node=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n1)
  : "${FUSIONOCC_COORDINATOR:=${first_node}:${FUSIONOCC_PORT:-29500}}"
  : "${FUSIONOCC_NUM_HOSTS:=${SLURM_NNODES:-${SLURM_NTASKS:-1}}}"
  : "${FUSIONOCC_HOST_ID:=${SLURM_NODEID:-${SLURM_PROCID:-0}}}"
fi
: "${FUSIONOCC_COORDINATOR:=localhost:29500}"
: "${FUSIONOCC_NUM_HOSTS:=1}"
: "${FUSIONOCC_HOST_ID:=0}"
: "${FUSIONOCC_CARDS_PER_HOST:=$(nvidia-smi --list-gpus | wc -l)}"

exec python -m torch.distributed.run \
  --nnodes="$FUSIONOCC_NUM_HOSTS" \
  --node_rank="$FUSIONOCC_HOST_ID" \
  --nproc_per_node="$FUSIONOCC_CARDS_PER_HOST" \
  --master_addr="${FUSIONOCC_COORDINATOR%:*}" \
  --master_port="${FUSIONOCC_COORDINATOR##*:}" \
  "$(dirname "$0")/train_torch.py" "$@"
