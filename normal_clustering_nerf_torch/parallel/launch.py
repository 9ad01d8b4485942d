"""Process-group bring-up of the port (the JAX package's
`parallel/launch.py`): one process a card, joined by `torch.distributed`.

`initialize_multihost` joins the processes of a run from its arguments or
from the environment: the JAX package's names (`COORDINATOR_ADDRESS`,
`NUM_PROCESSES`, `PROCESS_ID`) or torchrun's (`MASTER_ADDR` and
`MASTER_PORT`, `WORLD_SIZE`, `RANK`); `LOCAL_RANK` names the card a
process runs on (its rank by default). The backend is NCCL for the card
and gloo for the CPU. `spawn` starts the N processes of one host itself,
each with that environment, so that `--num_chips N` alone trains on N
cards, as it does in JAX. Nothing falls back: fewer cards than ranks, an
init that fails or a rank that dies raises.
"""
from __future__ import annotations

import os
import pickle
import shutil
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist


def _from_env():
    """(address, processes, id) of the environment: the JAX package's
    names first, then torchrun's."""
    env = os.environ
    if env.get("COORDINATOR_ADDRESS"):
        return (env["COORDINATOR_ADDRESS"], int(env.get("NUM_PROCESSES", 1)),
                int(env.get("PROCESS_ID", 0)))
    if env.get("MASTER_ADDR") and env.get("MASTER_PORT"):
        return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                int(env.get("WORLD_SIZE", 1)), int(env.get("RANK", 0)))
    return None, 1, 0


def launched() -> bool:
    """Whether this process is one rank of a process group: one is
    initialised, or the environment describes one of more than one
    process."""
    addr, n, _ = _from_env()
    return dist.is_initialized() or (bool(addr) and n > 1)


def local_rank() -> int:
    """The card of this process: `LOCAL_RANK`, else its rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else _from_env()[2]


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         device: str = "cuda",
                         backend: Optional[str] = None) -> bool:
    """Join the process group from the arguments or the environment (see
    the module's docstring); an address with "://" is the init method as
    it is (a `file://` store), else `tcp://<address>`. No-op returning
    False in a single process (no address, or one process); True when a
    group is (or already was) initialised. `backend` defaults to NCCL for
    `device` "cuda" (this process takes card `local_rank()`) and gloo for
    "cpu"."""
    if dist.is_initialized():
        return True
    env_addr, env_n, env_id = _from_env()
    addr = coordinator_address or env_addr
    n = env_n if num_processes is None else num_processes
    rank = env_id if process_id is None else process_id
    if not addr or n <= 1:
        return False
    device = torch.device(device).type
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    if device == "cuda":
        cards = torch.cuda.device_count()
        card = int(os.environ.get("LOCAL_RANK", rank))
        if card >= cards:
            raise RuntimeError(f"rank {rank} of {n} runs on card {card}, and "
                               f"{cards} card(s) are visible")
        torch.cuda.set_device(card)
    if backend == "nccl":
        # NCCL collectives inside CUDA graphs (PyTorch's notes on CUDA
        # graphs with DistributedDataParallel): no asynchronous error
        # handling; a rank that dies ends the run through its launcher
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "0")
    method = addr if "://" in addr else f"tcp://{addr}"
    dist.init_process_group(backend, init_method=method, world_size=n,
                            rank=rank)
    return True


def _worker(rank: int, fn: Callable, n: int, store: str, args: tuple,
            threads: int, out: str, local_ranks):
    os.environ.update(COORDINATOR_ADDRESS=store, NUM_PROCESSES=str(n),
                      PROCESS_ID=str(rank),
                      LOCAL_RANK=str(rank if local_ranks is None
                                     else local_ranks[rank]))
    torch.set_num_threads(threads)
    result = fn(*args)
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(result, f)
    # on an error the process ends without this (a rank's teardown can
    # wait on ranks that have stopped), and the launcher ends the others
    if dist.is_initialized():
        dist.destroy_process_group()


def require_cards(n: int):
    """Raise unless `n` cards are visible."""
    cards = torch.cuda.device_count()
    if n > cards:
        raise RuntimeError(f"{n} ranks on the card need {n} cards; {cards} "
                           "are visible")


def spawn(fn: Callable, n: int, args: tuple = (), device: str = "cuda",
          local_ranks=None):
    """Run `fn(*args)` in `n` new processes of this host, rank r with the
    environment of `initialize_multihost` (a `file://` store in a new
    temporary directory, `LOCAL_RANK` r or `local_ranks[r]`: the card it
    runs on) and this process's torch thread count, and wait for all.
    Returns rank 0's return value. Raises when "cuda" asks for more ranks
    than there are cards (unless `local_ranks` puts several on one, as a
    gloo run may), when a rank raises (the others are ended), and exits
    with a rank's exit code when one calls `sys.exit` with it."""
    if device == "cuda" and local_ranks is None:
        require_cards(n)
    tmp = tempfile.mkdtemp(prefix="ncnerf_ranks_")
    out = os.path.join(tmp, "rank0.pkl")
    try:
        torch.multiprocessing.start_processes(
            _worker, args=(fn, n, f"file://{tmp}/store", args,
                           torch.get_num_threads(), out, local_ranks),
            nprocs=n, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)
    except torch.multiprocessing.ProcessExitedException as e:
        if e.exit_code and e.exit_code > 0:
            raise SystemExit(e.exit_code) from e
        raise
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
