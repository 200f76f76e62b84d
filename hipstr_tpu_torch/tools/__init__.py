"""The port's measuring tools: the chromosome-scale soak (`soak`), a host
profile of the bench's run (`profile_host`) and the native decode and
filter throughput (`decode_bench`)."""
