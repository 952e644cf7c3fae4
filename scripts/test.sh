#!/bin/bash
# Single-command suite run that SURVIVES the environmental XLA-CPU
# backend_compile segfault flake (jaxlib's CPU backend
# intermittently segfaults during compilation; reruns pass and the crash
# point moves — it is not a test bug).
#
# Mechanism: pytest-xdist with ONE worker subprocess (-n 1).  The pytest
# master survives a worker segfault, restarts the worker, reschedules the
# remaining tests, and reports the crashed test as FAILED.  A second pass
# then reruns only the recorded failures (--lf); an intermittent crash
# passes there and the suite exits green, while a genuinely-broken test
# stays red.  This box has 1 CPU, so -n 1 costs no parallelism.
#
# Usage: scripts/test.sh [--smoke] [extra pytest args / test paths]
#   --smoke: the fast lane (~<10 min) — skips tests marked `full` or
#   `slow` (the ~20 heaviest: oracle fits, convergence sweeps, L-BFGS
#   round trips).  Use for inner-loop red-green iteration; gates and
#   round-end verification run the full suite.
set -u
cd "$(dirname "$0")/.."
if [ "${1:-}" = "--smoke" ]; then
    shift
    set -- -m "not slow and not full" "$@"
fi
args=("${@:-tests/}")
python -m pytest -q -n 1 --max-worker-restart=8 "${args[@]}"
rc=$?
if [ $rc -ne 0 ]; then
    echo "[suite] non-green first pass (rc=$rc); rerunning recorded" \
         "failures once — environmental crash-flake containment"
    python -m pytest -q -n 1 --max-worker-restart=8 \
        --lf --last-failed-no-failures none "${args[@]}"
    rc=$?
fi
exit $rc
