"""Traffic kinds: the general generators and drivers that traffic mixes
(``spcbench/traffic/<mix>.json``) name by their ``kind`` key."""
