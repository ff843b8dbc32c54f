"""The argument of each call, one module each, named by a traffic file's
`args.gen`: `make(params, data, seed)` returns `arg(i)`, the argument of
the window's call `i` (the warm-up sends `arg(0)`)."""
