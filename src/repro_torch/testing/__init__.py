# Test and benchmark support (not part of the dataplane).
