import sys

from .cli import main

if __name__ == "__main__":  # importing the module runs no pass
    sys.exit(main())
