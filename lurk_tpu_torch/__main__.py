"""python -m lurk_tpu_torch repl|load|microchain: see cli/__init__.py."""

import sys

if __name__ == "__main__":
    from .cli import run
    sys.exit(run())
