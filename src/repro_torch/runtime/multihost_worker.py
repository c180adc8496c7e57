"""Worker-process entry point, kept separate from runtime/multihost.py
so ``python -m`` launches don't re-execute a module the
``repro_torch.runtime`` package already imported (runpy's double-import
warning).  Importing it does nothing.

    python -m repro_torch.runtime.multihost_worker \
        --coordinator HOST:PORT --rank R [--procs N]
"""
from repro_torch.runtime.multihost import worker_cli

if __name__ == "__main__":
    worker_cli()
