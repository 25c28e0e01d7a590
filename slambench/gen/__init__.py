"""Traffic generators: `slambench/traffic/<mix>.json` names one of these
modules under `generator`; each has a `Workload` class."""
