import sys

if __name__ == "__main__":
    from .procs import adopt_orphans
    from .run import main
    adopt_orphans()
    sys.exit(main())
