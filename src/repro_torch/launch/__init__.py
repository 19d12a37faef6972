"""Entry points of the port: ``serve`` (prefill + decode on the card)."""
