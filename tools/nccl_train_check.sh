#!/bin/bash
# Parallel decode and training over NCCL, one card a rank, on a host with
# four NVIDIA GPUs, beside the same dry run over gloo with four ranks on
# one card:
#
#     bash tools/nccl_train_check.sh > nccl_check.log 2>&1
#
# Steps: the 4-rank dry run (parallel/dryrun.py: the pp2 dp1 tp2 + sp train
# step and exact tp 4 decode codes) over nccl, then over gloo on cuda:0;
# finetune on synthetic-tiny (pp 2, tp 2, sp) for 2 steps with a checkpoint
# a step, resumed for a third; finetune on the dense flagship at batch 8
# for 3 steps with an export, which one process then loads and decodes.
# Each step prints its exit code and seconds; data and outputs go under
# build/ (ignored by git).
cd "$(dirname "$0")/.."
export PYTHONPATH=src
set -x
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
python3 -c 'import sys, torch; print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.device_count())'
s=$(date +%s)
timeout 300 torchrun --nproc-per-node 4 --master-port 29517 -m qwen3_tts_tpu_torch.parallel.dryrun --backend nccl; echo "rc $? dryrun_nccl $(( $(date +%s) - s )) s"
s=$(date +%s)
timeout 300 python3 -m qwen3_tts_tpu_torch.parallel.dryrun --nprocs 4 --backend gloo --device cuda:0; echo "rc $? dryrun_gloo_one_card $(( $(date +%s) - s )) s"
python3 -c 'import sys; sys.path[:0] = [".", "src"]; import chip_smoke; chip_smoke.write_train_pairs("build/nccl_data")'
s=$(date +%s)
QWEN3_TTS_METRICS=1 timeout 300 torchrun --nproc-per-node 4 --master-port 29518 -m qwen3_tts_tpu_torch.finetune --model synthetic-tiny --data build/nccl_data --steps 2 --batch-size 8 --pp 2 --sequence-parallel --backend nccl --ckpt-dir build/nccl_ck --save-every 1; echo "rc $? finetune_tiny_nccl $(( $(date +%s) - s )) s"
s=$(date +%s)
QWEN3_TTS_METRICS=1 timeout 300 torchrun --nproc-per-node 4 --master-port 29519 -m qwen3_tts_tpu_torch.finetune --model synthetic-tiny --data build/nccl_data --steps 3 --batch-size 8 --pp 2 --sequence-parallel --backend nccl --ckpt-dir build/nccl_ck --resume; echo "rc $? finetune_tiny_nccl_resume $(( $(date +%s) - s )) s"
s=$(date +%s)
QWEN3_TTS_METRICS=1 timeout 400 torchrun --nproc-per-node 4 --master-port 29520 -m qwen3_tts_tpu_torch.finetune --model synthetic --data build/nccl_data --steps 3 --batch-size 8 --pp 2 --sequence-parallel --backend nccl --export build/nccl_export; echo "rc $? finetune_flagship_nccl $(( $(date +%s) - s )) s"
timeout 200 python3 - <<'PY'
import sys, tempfile, os, wave, time
sys.path[:0] = ["src"]
from qwen3_tts_tpu_torch.engine import generate_audio, load_model
t0 = time.perf_counter()
m = load_model("build/nccl_export", device="cuda")
with tempfile.TemporaryDirectory() as out:
    r = generate_audio(model=m, text="The export of four ranks.", voice=m.cfg.speakers[0], output_path=out, max_frames=16, seed=0)
    with wave.open(os.path.join(out, "audio_000.wav"), "rb") as w:
        print("export_decode", r["frames"], w.getnframes(), time.perf_counter() - t0)
PY
echo "rc $? export_decode"
