"""How the window drives its calls, one module each, named by a traffic
file's `loop`: `run(send, arg, traffic, seconds, keep) -> list[Call]`."""
