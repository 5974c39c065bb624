"""``python -m horovod_tpu_torch.runner`` — the port's launcher
(reference: ``python -m horovod.runner``, an alias for horovodrun)."""

from .launch import main

main()
