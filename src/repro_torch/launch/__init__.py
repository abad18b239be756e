"""Launching the LM on a mesh (port of ``repro.launch``): the mesh
(``mesh``), the partition rules and their DTensor placements
(``sharding``), the dry-run cells' inputs on the ``meta`` device
(``specs``), the training launcher (``train``), the dry run
(``dryrun``) and its variants (``hillclimb``)."""
