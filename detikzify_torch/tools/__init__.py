"""The port's counterparts of the repository's ``tools/verify_real.py`` and
``tools/convert_dreamsim.py``, run as ``python -m
detikzify_torch.tools.<name>``."""
