"""Launchers (port of ``horovod_tpu/runner``; reference analog:
horovod/runner/).

``python -m horovod_tpu_torch.runner`` is the JAX package's ``tpurun``
(``horovodrun``) for the port: it starts one process per slot (one per
GPU), exports the placement as the ``HVD_TPU_*`` variables ``hvd.init()``
reads (rank 0's ``tcp://`` store address, world size, rank, local rank
and size) with a per-job secret, and monitors the children, terminating
all on the first failure.  With ``--host-discovery-script`` it runs the
elastic driver (:mod:`.elastic_driver`) instead.
"""

from .launch import run, run_commandline  # noqa: F401
