"""The comparisons that decide `correct`, one file each, named by the
traffic file's `check`."""
