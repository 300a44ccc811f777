"""``python -m gossip_tpu_torch``: the port's command line."""

import sys

from gossip_tpu_torch.cli import main

if __name__ == "__main__":
    sys.exit(main())
