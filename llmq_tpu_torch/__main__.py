"""``python -m llmq_tpu_torch worker run MODEL QUEUE``: see ``cli/main.py``."""

import sys

from llmq_tpu_torch.cli.main import main

if __name__ == "__main__":
    sys.exit(main())
