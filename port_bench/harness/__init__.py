"""The benchmark's own library: the cell spec, the inputs, the trace and
its reduction, the frozen work models and peaks, the statistics."""
