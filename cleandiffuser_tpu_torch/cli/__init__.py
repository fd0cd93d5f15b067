"""The port's command-line entry points (counterparts of the JAX package's
`pipelines/<algo>_<benchmark>.py` scripts), run as
`python -m cleandiffuser_tpu_torch.cli.<name> key=value ...`."""
