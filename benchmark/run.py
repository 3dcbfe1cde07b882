"""The benchmark's command: one run of one cell on the device it is started on.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It prints the result as the last line of
standard output, and the numbers compared with their limits as the last
lines of standard error; it exits with a code other than 0 and prints no
result without the CUDA devices the cell asks for, or when JAX or the JAX
package has been loaded.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
