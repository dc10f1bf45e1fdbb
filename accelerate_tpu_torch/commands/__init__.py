"""The command line: ``launch`` (``python -m accelerate_tpu_torch.commands.launch``)
with its config file (``config.py``), argument parser and menu; the JAX
package's other subcommands are not ported yet (ROADMAP A9)."""
