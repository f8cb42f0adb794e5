"""``python -m perfbench --workload <name> --seed <n> --seconds <s> --trace <0|1>``"""

import time

T0 = time.perf_counter()  # set-up is timed from here, before torch loads

if __name__ == "__main__":
    import sys

    from perfbench.harness import main

    sys.exit(main(t0=T0))
