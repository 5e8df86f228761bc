"""The repository's user tools and measurement utilities on the port, each
run as ``python -m modelcompression_tpu_torch.tools.<name>`` with the flags
and output of its counterpart in the repository's ``tools/``, plus
``--device`` (``cuda`` by default; ``cpu`` on request)."""
