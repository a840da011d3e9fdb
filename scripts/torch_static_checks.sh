#!/usr/bin/env bash
# The PyTorch port's standing privacy gate, the twin of
# scripts/static_checks.sh: the same bytecode-hygiene check, then the
# port's static gate (`python -m repro_torch.analysis`: every driver spec
# certified by the dispatch-level taint interpreter, the protocol lints,
# the kernel-knob lint, and the leak fixtures CAUGHT), then its runtime
# audit (`python -m repro_torch.obs audit`: the privacy ledger reconciled
# against the certified census, and the extra-reveal self-test FLAGGED).
#
#   scripts/torch_static_checks.sh [--device cpu|cuda] [--verbose] [--json]
#                                  [--drivers SUBSTR]
#
# `--device` goes to both halves (default: the CUDA card; `--device cpu`
# runs both on the CPU); the other arguments go to the static gate.
# Exit status 0 iff both halves are clean.
set -euo pipefail
cd "$(dirname "$0")/.."
export PYTHONPATH="src${PYTHONPATH:+:$PYTHONPATH}"

# repo hygiene: compiled bytecode must never be tracked
if git ls-files -- '*.pyc' '*__pycache__*' | grep -q .; then
    echo "torch_static_checks: tracked Python bytecode found:" >&2
    git ls-files -- '*.pyc' '*__pycache__*' >&2
    echo "torch_static_checks: run 'git rm -r --cached' on the paths above" >&2
    exit 1
fi

device=()
rest=()
while [ $# -gt 0 ]; do
    case "$1" in
        --device) device=(--device "$2"); shift 2 ;;
        --device=*) device=("$1"); shift ;;
        *) rest+=("$1"); shift ;;
    esac
done

status=0
python -m repro_torch.analysis ${device[@]+"${device[@]}"} \
    ${rest[@]+"${rest[@]}"} || status=1
python -m repro_torch.obs audit ${device[@]+"${device[@]}"} || status=1
if [ "$status" -ne 0 ]; then
    echo "torch_static_checks: the gate or the audit is not clean" >&2
fi
exit "$status"
