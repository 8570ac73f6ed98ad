"""``python -m tpucg_torch`` — see tpucg_torch.cli."""

import sys

from tpucg_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
