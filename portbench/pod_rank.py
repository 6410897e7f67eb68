"""One rank above 0 of a cell that runs on several ranks; rank 0 (the
benchmark's own process) starts it as

    python -m portbench.pod_rank '<job as JSON>'
"""

import json
import sys

from portbench.harness import rank_main

if __name__ == "__main__":
    rank_main(json.loads(sys.argv[1]))
