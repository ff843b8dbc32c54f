"""The harness: spec resolution, spans, the device trace, the roofline
count, the import guard and the run itself."""
