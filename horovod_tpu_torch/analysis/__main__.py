"""``python -m horovod_tpu_torch.analysis`` — run the contract checker."""

import sys

from . import main

sys.exit(main())
