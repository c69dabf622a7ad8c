"""Local launch of N ranks for a CLI run with ``--num_devices N`` (what the
JAX CLI gets from one process over a mesh of N devices; under torchrun each
process already is a rank, and joins the group it is given, on one host or
many).

:func:`run` starts N processes with the ``spawn`` start method, each with
the environment torchrun would give it (``RANK`` = ``LOCAL_RANK`` = i,
``WORLD_SIZE`` N, ``MASTER_ADDR`` localhost, a free ``MASTER_PORT``), and
calls the CLI's ``main`` with the same command line there; each rank then
joins the group (``parallel/mesh.py`` ``init_process_group``).  A rank that
fails ends the others and fails the run.  SIGINT from a terminal reaches
every process of the foreground group, so the parent leaves it to the
ranks (each saves at its next step boundary, where they agree to stop);
a SIGTERM sent to the parent alone is passed on to every rank.
"""

from __future__ import annotations

import importlib
import os
import signal
import socket

import torch
import torch.multiprocessing as tmp

POLL = 0.5      # s between reads of rank 0's result while the ranks run


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _rank_main(index, module, argv, world, port, results):
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index),
                      WORLD_SIZE=str(world), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    # the ranks share the host's cores
    torch.set_num_threads(max(1, torch.get_num_threads() // world))
    cli = importlib.import_module(module)
    result = cli.main(argv)
    if index == 0:
        results.put(getattr(cli, "parent_result", lambda r: r)(result))


def run(module: str, argv, world: int):
    """``module``'s ``main(argv)`` on ``world`` local ranks (module
    docstring); returns what rank 0's module gives its parent
    (``parent_result(result)`` where the module defines it, else the
    result itself).  Raises if a rank fails."""
    results = tmp.get_context("spawn").SimpleQueue()
    context = tmp.start_processes(
        _rank_main, args=(module, list(argv), world, free_port(), results),
        nprocs=world, join=False, start_method="spawn")

    def forward(signum, _frame):
        for pid in context.pids():
            try:
                os.kill(pid, signum)
            except ProcessLookupError:
                pass

    previous = {signal.SIGINT: signal.signal(signal.SIGINT, signal.SIG_IGN),
                signal.SIGTERM: signal.signal(signal.SIGTERM, forward)}
    result = None
    try:
        # rank 0's result is read while the ranks run: its ``put`` blocks
        # until a reader drains the pipe, so joining first would wait on a
        # rank 0 that cannot exit
        while not context.join(timeout=POLL):
            if not results.empty():
                result = results.get()
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    return results.get() if not results.empty() else result
