"""Command-line entry points (counterpart of the repository's ``examples/``
scripts): ``eval``, ``infer``, ``serve_bench``, ``train``, ``pretrain``,
``refine``, ``sketchify``, ``spec_acceptance`` and
``tikzero.{pretrain,train}``, each run as
``python -m detikzify_torch.examples.<name>`` and each ``main`` taking an
optional ``argv``. They run on the card unless ``--device cpu`` is given.
Nothing here parses arguments or imports ``datasets``, ``diffusers`` or
``requests`` when imported."""
