"""Launchers (port of ``repro.launch``): the train and serve command-line
entry points, on the card unless ``--device cpu`` is given; the meshes,
meta stand-ins and steps of the sharded launch path; and the dry run with
its H100 roofline, which runs on the meta device."""
