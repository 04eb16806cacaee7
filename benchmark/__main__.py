"""python3 -m benchmark --workload <name> --seed <n> --seconds <s> --trace <0|1>"""

import time

STARTED = time.monotonic()

import sys  # noqa: E402

from .run import main  # noqa: E402

sys.exit(main(started=STARTED))
