"""A pool worker: runs ``module:function`` tasks read from standard input
and writes each result, or its traceback, to standard output (see
``pool.py``). Anything a task prints goes to standard error."""

from __future__ import annotations

import importlib
import os
import sys
import traceback

from stitchbench.common.pool import receive, send


def main() -> None:
    tasks = os.fdopen(os.dup(0), "rb")
    results = os.fdopen(os.dup(1), "wb")
    sys.stdout = sys.stderr
    while True:
        msg = receive(tasks)
        if msg is None:
            return
        i, target, args = msg
        module, name = target.split(":")
        if module.split(".")[0] != "stitchbench":
            send(results, (i, False, f"refused: {target} is not under stitchbench"))
            continue
        try:
            value = getattr(importlib.import_module(module), name)(*args)
        except Exception:
            send(results, (i, False, traceback.format_exc()))
        else:
            send(results, (i, True, value))


if __name__ == "__main__":
    main()
