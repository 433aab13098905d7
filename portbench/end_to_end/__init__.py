"""End-to-end metrics: ``end_to_end/<name>.py`` has ``read(window)``, with
``window`` a :class:`portbench.harness.Window`, and returns a number."""
