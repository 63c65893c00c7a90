"""One reader a metric, loaded by the metric's name (``<name>.py``)."""
