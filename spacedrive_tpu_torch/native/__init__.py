"""Native (C) host components of the port, loaded through ctypes and
built at first use into `spacedrive_tpu_torch/_build/` (build.py)."""
