"""The yardstick: the table of peaks, the operation and byte counts of the
work the cells ask for, and the reduction of a profiler trace to busy and
idle time. Later changes to the program cannot move any of it."""
