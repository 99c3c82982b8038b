"""`python -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>`"""

import time

T0 = time.perf_counter()

if __name__ == "__main__":
    import sys

    from port_bench.run import main

    sys.exit(main(t0=T0))
