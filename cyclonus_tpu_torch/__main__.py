import sys

from .cli import main

if __name__ == "__main__":
    # the return value is the process exit code: a failed case exits nonzero
    sys.exit(main())
