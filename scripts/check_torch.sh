#!/usr/bin/env bash
# CI gate of the PyTorch/H100 port (src/repro_torch), the counterpart of
# scripts/check.sh's gates up to the coverage floors:
#   scripts/check_torch.sh [--gpu] [extra pytest args...]
# 1. `python -m repro_torch.analysis` (R001-R006 over the port and
#    chip_smoke.py) fails fast on any unsuppressed finding.
# 2. The port's fault matrices (training supervisor, serving) fail fast:
#    a broken recovery path invalidates every longer gate below.
# 3. ruff, where it is installed (config in ruff.toml).
# 4. The port's test suite, tests/test_torch_*.py; the extra arguments go
#    to this run (e.g. `-p xdist -n 4 --dist loadfile`).
# 5. scripts/coverage_gate_torch.py: line-coverage floors over
#    repro_torch.core+kernels and repro_torch.serve.
# 6. With --gpu, on a machine with an NVIDIA GPU and nvcc: the GPU-marked
#    tests and chip_smoke.py. Without it the script says that they did not
#    run. The benchmark tripwires of check.sh have no port counterpart yet.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH=src${PYTHONPATH:+:$PYTHONPATH}

gpu=0
if [[ "${1:-}" == "--gpu" ]]; then
    gpu=1
    shift
fi

python -m repro_torch.analysis

python -m pytest -q tests/test_torch_supervisor.py \
    tests/test_torch_serve_matrix.py -k "matrix"

if command -v ruff >/dev/null 2>&1; then
    ruff check .
else
    echo "check_torch: ruff not installed; skipping lint (config in ruff.toml)"
fi

python -m pytest -x -q tests/test_torch_*.py "$@"

python scripts/coverage_gate_torch.py

if [[ "$gpu" == 1 ]]; then
    python -m pytest -q -m gpu tests/test_torch_gpu.py tests/test_torch_gpu_gat.py
    python3 chip_smoke.py
else
    echo "check_torch: the card gates did not run (pass --gpu on a machine" \
         "with an NVIDIA GPU: pytest -m gpu tests/test_torch_gpu.py" \
         "tests/test_torch_gpu_gat.py," \
         "python3 chip_smoke.py)"
fi
