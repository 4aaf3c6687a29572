"""`python -m byzantinemomentum_tpu_torch.obs <run_dir>`: the one-page
report of a run directory (`obs/report.py`), the JAX package's
`<run_dir>` mode. Its `--selfcheck` mode is not ported yet (`ROADMAP.md`
section 1 item 4)."""

import sys

from byzantinemomentum_tpu_torch.obs.report import main

if __name__ == "__main__":
    sys.exit(main())
