"""Several devices: the ('data', 'model') mesh over a `torch.distributed`
process group (`mesh.py`), the process helpers and the collectives that
autograd differentiates (`distributed.py`), and the multi-device dry run
(`dryrun.py`)."""
