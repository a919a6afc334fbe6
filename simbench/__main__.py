"""``python3 -m simbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell on the card (see harness.py)."""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from simbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
