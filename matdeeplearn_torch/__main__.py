"""`python -m matdeeplearn_torch`: the port's CLI (cli.py)."""

from matdeeplearn_torch.cli import main

if __name__ == "__main__":
    main()
