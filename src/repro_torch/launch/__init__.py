"""Entry points of the port: ``train`` (the FedDF CLI), ``serve`` (prefill +
decode on the card), ``steps`` (the per-(arch, shape) step builders) and
``dryrun`` (their analytic count for one H100)."""
