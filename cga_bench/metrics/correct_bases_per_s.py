"""correct_bases_per_s: read bases of the completed jobs of `cli correct`
over the window from the first job's start to the last job's end."""


def read(rec):
    return rec["bases"] / rec["elapsed_s"]
