"""python -m charon_tpu_torch — CLI entry point (reference: main.go:23)."""

import sys

from .cmd import main

if __name__ == "__main__":  # importing the module (a package walk) runs nothing
    sys.exit(main())
