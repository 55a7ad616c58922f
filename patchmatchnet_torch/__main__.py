"""`python -m patchmatchnet_torch <command>`: the port's command line."""

from patchmatchnet_torch.cli import main

if __name__ == "__main__":
    main()
