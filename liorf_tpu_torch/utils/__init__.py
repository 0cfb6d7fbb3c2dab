"""Host-side utilities (numpy and the standard library; timing with torch)."""
