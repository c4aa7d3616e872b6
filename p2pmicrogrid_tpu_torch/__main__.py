"""``python -m p2pmicrogrid_tpu_torch`` — the port's command line
(``cli.py``). The call is guarded, so importing this module (the isolation
test walks every module) runs nothing."""

import sys

from p2pmicrogrid_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
