"""`python -m mythril_tpu_torch` == the `myth` console script."""

from .interfaces.cli import main

if __name__ == "__main__":
    main()
