#!/bin/bash
# Width sweep for one app — analog of scripts/profile_app.sh:6-22 in the
# reference (w = 64..4096 step 64; we sweep powers of two since XLA
# recompiles per shape). One process at a time: each JAX process reserves
# most of the card's memory.
#
# Usage: scripts/profile_app.sh apps/summed_table.py [extra args]

APP=${1:?usage: profile_app.sh <app.py> [args]}
shift
OUT="$(basename "$APP" .py).perflog"
: > "$OUT"
for W in 256 512 1024 2048 4096; do
    echo -n "$W  " | tee -a "$OUT"
    python "$APP" -w "$W" --nocheck -i 5 "$@" 2>/dev/null | tail -1 | tee -a "$OUT"
done
echo "wrote $OUT"
