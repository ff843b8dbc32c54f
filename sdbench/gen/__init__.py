"""Data generators, one module each, named by a configuration's `gen`:
`make(config, seed)` makes the data from the seed, `install(node, config,
data, seed, tmp)` puts it where a node that has not started finds it and
returns the library's id, and `started(node, config, library_id)` sets
the library as the host would have it once the node has loaded it."""
