"""``python -m infodiffusion_tpu_torch <run.py flags>``: the port's CLI."""

from infodiffusion_tpu_torch.cli import main

if __name__ == "__main__":
    main()
