"""The same argument on every call: `params["value"]`."""


def make(params, data, seed):
    value = params["value"]
    return lambda i: value
