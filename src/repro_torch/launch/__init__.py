"""Launchers: the train and serve command-line entry points (port of
``repro.launch``'s ``train`` and ``serve``), on the card unless
``--device cpu`` is given."""
