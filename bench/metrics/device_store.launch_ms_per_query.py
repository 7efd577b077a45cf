"""device_store.launch_ms_per_query: ms the host spends issuing fused
launches per query answered in the traced window: the total time of the
program's ``device_store.launch`` spans (one a fused or stacked launch,
with the count issued right behind it), over the window's answers.
Closed-loop cells; moves qps."""


def read(run):
    return run.ms_per_answer(run.host_s("device_store.launch"))
