"""The serving tier of the port: so far only the metrics registry
(`metrics.py`), which every Context owns and SHOW METRICS reads.  The
admission gate, scheduler, result cache and runtime are ROADMAP.md Queue 1
item 8b."""
