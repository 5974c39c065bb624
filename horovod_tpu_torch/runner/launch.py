"""The port's launcher CLI: ``python -m horovod_tpu_torch.runner``.

Port of ``horovod_tpu/runner/launch.py`` (``tpurun``; reference parity:
horovod/runner/launch.py + gloo_run.py): parse -np/-H/--hostfile/knob
flags/--config-file, start one worker process per slot (one per GPU)
with the placement exported, monitor, and kill everything on the first
failure.

  * rendezvous = rank 0's ``torch.distributed`` TCP store at
    ``HVD_TPU_COORDINATOR`` (``basics.init`` turns it into
    ``init_method="tcp://..."``), replacing the reference's
    launcher-hosted HTTP KV store;
  * each worker's environment carries ``HVD_TPU_COORDINATOR``,
    ``HVD_TPU_NUM_PROCESSES``, ``HVD_TPU_PROCESS_ID``,
    ``HVD_TPU_LOCAL_RANK``, ``HVD_TPU_LOCAL_SIZE`` and the job secret
    ``HVD_TPU_SECRET``; torchrun's variables are removed from it (they
    would win at init);
  * remote hosts are reached with plain ssh like the reference's
    gloo_run, the secret on ssh's stdin, never on the argv.

Before a local fan-out the TensorFlow adapter's XLA bridge is built
once (:func:`prebuild_tf_bridge`).  Not ported: the JAX package's
native-controller build before fan-out (the port has no native core
yet); ``--disable-native`` is accepted and exported.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .config_parser import config_to_env, load_config_file

#: torchrun's placement variables: ``basics.init`` prefers them over the
#: launcher's, so a launch from inside a torchrun job must not leak them
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                 "MASTER_ADDR", "MASTER_PORT", "GROUP_RANK",
                 "ROLE_RANK", "ROLE_WORLD_SIZE")


def ensure_sigterm_unwinds():
    """Convert SIGTERM into SystemExit so a terminated launcher unwinds
    through its finally-blocks and kills the worker fleet — the default
    handler exits without unwinding and ORPHANS every worker.  No-op off
    the main thread, where the default behavior stands anyway.

    Returns a zero-arg restore callable: library embeddings must not
    leave the process-wide handler permanently replaced."""

    def _raise(signum, frame):
        raise SystemExit(128 + signum)

    try:
        prev = signal.signal(signal.SIGTERM, _raise)
    except ValueError:
        return lambda: None

    def _restore():
        try:
            signal.signal(signal.SIGTERM, prev)
        except (ValueError, TypeError):
            pass

    return _restore


def reap_workers(procs: List["subprocess.Popen"],
                 grace_s: float = 5.0) -> None:
    """terminate → grace → SIGKILL → wait.  A worker may handle SIGTERM
    itself (``fleet.PreemptionGuard``'s planned leave), so the grace is
    bounded and followed by SIGKILL."""
    alive = [p for p in procs if p.poll() is None]
    for p in alive:
        p.terminate()
    deadline = time.time() + grace_s
    while time.time() < deadline:
        if all(p.poll() is not None for p in alive):
            return
        time.sleep(0.1)
    for p in alive:
        if p.poll() is None:
            p.kill()
    for p in alive:
        # SIGKILL cannot be blocked, so this wait is bounded; without it
        # the killed children linger as zombies in long-lived callers
        p.wait()


def monitor_lockstep(procs: List["subprocess.Popen"],
                     label: str = "horovod_tpu_torch.runner") -> int:
    """Exit-code lockstep monitoring: first nonzero exit terminates the
    rest (reference: gloo_run's monitor loop).  Any exception —
    including the SIGTERM-as-SystemExit from ensure_sigterm_unwinds —
    reaps the fleet before propagating."""
    restore_handler = ensure_sigterm_unwinds()
    try:
        while True:
            codes = [p.poll() for p in procs]
            for rank, code in enumerate(codes):
                if code is not None and code != 0:
                    print(f"[{label}] rank {rank} exited with {code}; "
                          "terminating remaining workers", file=sys.stderr)
                    reap_workers(procs)
                    return code
            if all(c == 0 for c in codes):
                return 0
            time.sleep(0.1)
    except BaseException:
        reap_workers(procs)
        raise
    finally:
        restore_handler()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def parse_host_spec(spec: str) -> List[Tuple[str, int]]:
    """'h1:4,h2:4' -> [(h1, 4), (h2, 4)] (reference: runner/hosts.py)."""
    hosts = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if ":" in part:
            name, slots = part.rsplit(":", 1)
            hosts.append((name, int(slots)))
        else:
            hosts.append((part, 1))
    return hosts


def parse_hostfile(path: str) -> List[Tuple[str, int]]:
    """One 'host slots=N' per line (reference: --hostfile format)."""
    hosts = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line:
                continue
            fields = line.split()
            slots = 1
            for fld in fields[1:]:
                if fld.startswith("slots="):
                    slots = int(fld.split("=", 1)[1])
            hosts.append((fields[0], slots))
    return hosts


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m horovod_tpu_torch.runner",
        description="Launch a distributed training job "
                    "(horovodrun-compatible surface, PyTorch/CUDA port).",
    )
    p.add_argument("-np", "--num-proc", type=int, default=None,
                   help="total number of worker processes (one per GPU)")
    p.add_argument("-H", "--hosts", default=None,
                   help="comma-separated host:slots list")
    p.add_argument("--hostfile", default=None,
                   help="file with one 'host slots=N' per line")
    p.add_argument("--config-file", default=None,
                   help="YAML file of knob settings (reference format)")
    p.add_argument("--ssh-port", type=int, default=None)
    p.add_argument("--output-filename", default=None,
                   help="redirect each rank's output to <file>.rank")
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--check-build", action="store_true",
                   help="print build capabilities and exit")
    p.add_argument("--disable-native", action="store_true",
                   help="force the Python controller (the port has no "
                        "native core yet; accepted and exported)")
    # knob flags (reference: horovodrun's tunable flags; see config_parser)
    p.add_argument("--fusion-threshold", dest="fusion_threshold", type=int)
    p.add_argument("--cycle-time-ms", dest="cycle_time_ms", type=float)
    p.add_argument("--cache-capacity", dest="cache_capacity", type=int)
    p.add_argument("--timeline-filename", dest="timeline_filename")
    p.add_argument("--timeline-mark-cycles", dest="timeline_mark_cycles",
                   action="store_const", const=True)
    p.add_argument("--no-stall-check", dest="stall_check_disable",
                   action="store_const", const=True)
    p.add_argument("--stall-warning-time", dest="stall_warning_time_seconds",
                   type=float)
    p.add_argument("--stall-shutdown-time",
                   dest="stall_shutdown_time_seconds", type=float)
    p.add_argument("--autotune", dest="autotune", action="store_const",
                   const=True)
    p.add_argument("--autotune-log", dest="autotune_log")
    p.add_argument("--log-level", dest="log_level")
    # elastic flags (reference: horovodrun --min-np/--max-np/
    # --host-discovery-script — runner/elastic/settings.py)
    p.add_argument("--min-np", type=int, default=None,
                   help="minimum workers to keep running (elastic mode)")
    p.add_argument("--max-np", type=int, default=None,
                   help="maximum workers (elastic mode)")
    p.add_argument("--host-discovery-script", default=None,
                   help="executable printing current 'host:slots' lines; "
                        "enables elastic mode")
    p.add_argument("--slots", type=int, default=1,
                   help="default slots per discovered host (elastic)")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="the training command, e.g. python train.py")
    return p


def kernels_built() -> Dict[str, bool]:
    """Whether each of the port's CUDA kernel libraries is already built
    (``ops/_build.py``'s hashed names under ``build/``); nothing is
    compiled here."""
    from ..ops import _build

    return {name: _build._lib_path(_build.CSRC / name).exists()
            for name in _build.SOURCES}


def check_build() -> str:
    """Reference: horovodrun --check-build output."""
    import torch
    import torch.distributed as dist

    import horovod_tpu_torch

    def box(flag: bool) -> str:
        return "X" if flag else " "

    cuda = torch.version.cuda
    gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
    built = kernels_built()
    lines = [
        f"horovod_tpu_torch v{horovod_tpu_torch.__version__}",
        f"torch {torch.__version__}, CUDA {cuda or 'none'}, {gpus} GPU(s)",
        "",
        "Available backends:",
        f"    [{box(dist.is_nccl_available())}] NCCL",
        f"    [{box(dist.is_gloo_available())}] gloo",
        f"    [{box(dist.is_mpi_available())}] MPI",
        "    [ ] native C++ controller core (not ported)",
        "",
        "CUDA kernels (built at first use from horovod_tpu_torch/csrc):",
    ] + [f"    [{box(ok)}] {name}" for name, ok in built.items()] + [
        "",
        "Available integrations:",
        "    [X] PyTorch",
    ]
    return "\n".join(lines)


def _with_job_secret(knob_env: Dict[str, str]) -> Dict[str, str]:
    """Return knob_env carrying the per-job control-plane secret (the
    elastic JSON-line signing, common/wire_auth.py, reads
    HVD_TPU_SECRET).  An inherited secret (the launcher itself running
    under a parent job) is kept so nested launches stay mutually
    reachable."""
    from ..common import wire_auth

    env = dict(knob_env)
    env.setdefault(
        wire_auth.SECRET_ENV,
        os.environ.get(wire_auth.SECRET_ENV) or wire_auth.make_secret(),
    )
    return env


def _worker_env(base: Dict[str, str], knob_env: Dict[str, str],
                coordinator: str, native_port: int, num_proc: int,
                rank: int, disable_native: bool,
                local_rank: int = 0, local_size: int = 1) -> Dict[str, str]:
    env = {k: v for k, v in base.items() if k not in _TORCHRUN_ENV}
    env.update(knob_env)
    # rank 0's torch.distributed TCP store (basics.init: tcp://...)
    env["HVD_TPU_COORDINATOR"] = coordinator
    # kept for the JAX package's native controller (its TCP star)
    env["HVD_TPU_NATIVE_PORT"] = str(native_port)
    env["HVD_TPU_NUM_PROCESSES"] = str(num_proc)
    env["HVD_TPU_PROCESS_ID"] = str(rank)
    # per-host placement: the local rank picks the card
    env["HVD_TPU_LOCAL_RANK"] = str(local_rank)
    env["HVD_TPU_LOCAL_SIZE"] = str(local_size)
    if disable_native:
        env["HVD_TPU_DISABLE_NATIVE"] = "1"
    return env


#: the TensorFlow adapter's XLA custom-call bridge, built with g++ by
#: ``tensorflow/xla_ops.py`` at first use (or by :func:`prebuild_tf_bridge`)
TF_BRIDGE_SRC = (Path(__file__).resolve().parent.parent / "tensorflow"
                 / "src" / "xla_bridge.cc")


def tf_bridge_path(tf_version: str) -> Path:
    """Where the TF XLA bridge is built for TensorFlow ``tf_version``:
    under ``build/horovod_tpu_torch/``, named by a hash of its source and
    that version (whose headers and library it is compiled against).
    Importing TensorFlow is not needed to ask."""
    from ..ops._build import BUILD_DIR

    h = hashlib.sha256(TF_BRIDGE_SRC.read_bytes() + tf_version.encode())
    return BUILD_DIR / f"libxla_bridge-{h.hexdigest()[:16]}.so"


def prebuild_tf_bridge(verbose: bool = False) -> None:
    """Build the TF XLA custom-call bridge ONCE before fan-out.

    Without this, N freshly-launched workers each import TF and compile
    the bridge (``horovod_tpu_torch/tensorflow/src/xla_bridge.cc``)
    concurrently on the same host, which can stretch worker boot past
    the rendezvous deadline.  When ``build/horovod_tpu_torch/`` already
    holds the library named by the source's hash and the installed TF
    version, this is a stat; otherwise a throwaway process runs the
    workers' own builder once (whose TF-import cost the workers would
    each have paid anyway).  Set HVD_TPU_PREBUILD_TF=0 to skip.  No-op when
    tensorflow is not installed."""
    if os.environ.get("HVD_TPU_PREBUILD_TF", "1") in ("0", "false"):
        return
    import importlib.util
    from importlib import metadata

    try:
        if importlib.util.find_spec("tensorflow") is None:
            return
    except (ImportError, ValueError):
        return
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for dist in ("tensorflow", "tensorflow-cpu"):
        try:
            if tf_bridge_path(metadata.version(dist)).exists():
                return  # built for this TF — nothing to do
            break
        except metadata.PackageNotFoundError:
            continue
    if verbose:
        print("[runner] pre-building the TF XLA bridge before fan-out",
              file=sys.stderr)
    subprocess.run(
        [sys.executable, "-c",
         "from horovod_tpu_torch.tensorflow import xla_ops; "
         "xla_ops.available()"],
        env=dict(os.environ, TF_CPP_MIN_LOG_LEVEL="3",
                 PYTHONPATH=os.pathsep.join(
                     p for p in (os.path.dirname(here),
                                 os.environ.get("PYTHONPATH")) if p)),
        capture_output=not verbose, timeout=600, check=False,
    )


def _launch_local(command: List[str], num_proc: int,
                  knob_env: Dict[str, str], output_filename: Optional[str],
                  verbose: bool, disable_native: bool) -> int:
    """Single-host launch: np processes on localhost, lockstep monitored.
    Reference: gloo_run's local exec path + exit-code monitoring."""
    prebuild_tf_bridge(verbose)
    coordinator = f"127.0.0.1:{_free_port()}"
    native_port = _free_port()
    knob_env = _with_job_secret(knob_env)
    procs: List[subprocess.Popen] = []
    outputs = []
    try:
        for rank in range(num_proc):
            env = _worker_env(os.environ.copy(), knob_env, coordinator,
                              native_port, num_proc, rank, disable_native,
                              local_rank=rank, local_size=num_proc)
            stdout = stderr = None
            if output_filename:
                f = open(f"{output_filename}.{rank}", "w")
                outputs.append(f)
                stdout = stderr = f
            if verbose:
                print(f"[runner] rank {rank}: {' '.join(command)}",
                      file=sys.stderr)
            procs.append(subprocess.Popen(
                command, env=env, stdout=stdout, stderr=stderr
            ))
        # monitor: first nonzero exit kills the job (reference behavior)
        return monitor_lockstep(procs)
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        return 130
    finally:
        for f in outputs:
            f.close()


def _launch_ssh(command: List[str], hosts: List[Tuple[str, int]],
                num_proc: int, knob_env: Dict[str, str],
                ssh_port: Optional[int], verbose: bool,
                disable_native: bool) -> int:
    """Multi-host launch over ssh, one process per host slot (reference:
    gloo_run.py's ssh exec).  The first host runs rank 0 and hosts the
    store."""
    from ..common import wire_auth

    coord_host = hosts[0][0]
    coordinator = f"{coord_host}:{_free_port()}"
    native_port = _free_port()
    knob_env = _with_job_secret(knob_env)
    # the secret must NEVER ride the ssh argv (visible to every local
    # user via /proc/*/cmdline for the job's lifetime): it travels on
    # ssh's stdin instead, read into the env by the remote preamble
    secret = knob_env.pop(wire_auth.SECRET_ENV)
    procs: List[subprocess.Popen] = []
    rank = 0
    for host, slots in hosts:
        used = min(slots, max(num_proc - rank, 0))
        for local_rank in range(used):
            env = _worker_env({}, knob_env, coordinator, native_port,
                              num_proc, rank, disable_native,
                              local_rank=local_rank, local_size=used)
            env_prefix = " ".join(
                f"{k}={subprocess.list2cmdline([v])}" for k, v in env.items()
            )
            remote_cmd = (
                f"IFS= read -r {wire_auth.SECRET_ENV} && "
                f"export {wire_auth.SECRET_ENV} && "
                f"cd {os.getcwd()} && {env_prefix} "
                + subprocess.list2cmdline(command)
            )
            ssh_cmd = ["ssh", "-o", "StrictHostKeyChecking=no"]
            if ssh_port:
                ssh_cmd += ["-p", str(ssh_port)]
            ssh_cmd += [host, remote_cmd]
            if verbose:
                print(f"[runner] rank {rank} on {host}", file=sys.stderr)
            p = subprocess.Popen(ssh_cmd, stdin=subprocess.PIPE)
            p.stdin.write((secret + "\n").encode())
            p.stdin.close()
            procs.append(p)
            rank += 1
    # same exit-code lockstep as the local path: first nonzero exit
    # reaps the whole fleet (reference: gloo_run's remote monitor)
    return monitor_lockstep(procs)


def run_commandline(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.check_build:
        print(check_build())
        return 0
    command = args.command
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("runner: no command given (e.g. python -m "
              "horovod_tpu_torch.runner -np 4 python train.py)",
              file=sys.stderr)
        return 2

    config = load_config_file(args.config_file) if args.config_file else {}
    knob_env = config_to_env(args, config)

    if args.host_discovery_script:
        # elastic mode (reference: horovodrun --host-discovery-script
        # switching launch.py into the ElasticDriver path)
        from .elastic_driver import ElasticDriver, HostDiscovery

        if args.disable_native:
            knob_env["HVD_TPU_DISABLE_NATIVE"] = "1"
        driver = ElasticDriver(
            command=command,
            discovery=HostDiscovery(args.host_discovery_script,
                                    default_slots=args.slots),
            min_np=args.min_np or args.num_proc or 1,
            max_np=args.max_np,
            knob_env=knob_env,
            verbose=args.verbose,
        )
        return driver.run()
    if args.min_np or args.max_np:
        print("runner: --min-np/--max-np require --host-discovery-script",
              file=sys.stderr)
        return 2

    if args.hostfile:
        hosts = parse_hostfile(args.hostfile)
    elif args.hosts:
        hosts = parse_host_spec(args.hosts)
    else:
        hosts = [("localhost", args.num_proc or 1)]
    total_slots = sum(s for _, s in hosts)
    num_proc = args.num_proc or total_slots
    if num_proc > total_slots:
        print(f"runner: requested -np {num_proc} but only {total_slots} "
              "slots available", file=sys.stderr)
        return 2

    local_only = all(h in ("localhost", "127.0.0.1", socket.gethostname())
                     for h, _ in hosts)
    if local_only:
        return _launch_local(command, num_proc, knob_env,
                             args.output_filename, args.verbose,
                             args.disable_native)
    return _launch_ssh(command, hosts, num_proc, knob_env, args.ssh_port,
                       args.verbose, args.disable_native)


def run(command: List[str], np: int = 1, **kwargs) -> int:
    """Programmatic launcher (reference: horovod.run)."""
    argv = ["-np", str(np)]
    for k, v in kwargs.items():
        flag = "--" + k.replace("_", "-")
        if isinstance(v, bool):
            if v:
                argv.append(flag)
        else:
            argv += [flag, str(v)]
    return run_commandline(argv + ["--"] + list(command))


def main() -> None:
    sys.exit(run_commandline())


if __name__ == "__main__":
    main()
