"""Granule openers per data source (HLS, Sentinel-2, Sentinel-1)."""
