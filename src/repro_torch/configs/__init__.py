"""Model configurations, copied verbatim from repro.configs."""
