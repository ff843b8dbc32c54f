"""Warm-ups, one module each, named by a traffic file's `warm`:
`run(node, library_id, data, arg)` warms the shapes of the window's
calls (with `arg`, the first call's argument) before the window opens."""
