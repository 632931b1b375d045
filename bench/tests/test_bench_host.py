"""The host's line (``bench/host.py``) from injected ``/proc`` and
``/sys`` trees, and the collector's runs counted inside a window."""

from __future__ import annotations

import gc
from types import SimpleNamespace

import pytest

from bench import host


@pytest.mark.parametrize("text, cpus", [
    ("0-15,32-47", set(range(16)) | set(range(32, 48))),
    ("3", {3}),
    ("", set()),
    ("0-3\n", {0, 1, 2, 3}),
    ("1,3,5-6", {1, 3, 5, 6}),
])
def test_cpulists_parse_and_format_back(text, cpus):
    assert host.parse_cpulist(text) == cpus
    assert host.parse_cpulist(host.format_cpulist(cpus)) == cpus


def test_cpulists_format_as_ranges():
    assert host.format_cpulist({0, 1, 2, 3, 8, 10, 11}) == "0-3,8,10-11"
    assert host.format_cpulist(set()) == ""


@pytest.mark.parametrize("props, bus", [
    (SimpleNamespace(pci_domain_id=0, pci_bus_id=25, pci_device_id=0), "0000:19:00.0"),
    (SimpleNamespace(pci_domain_id=1, pci_bus_id=0x9a, pci_device_id=3), "0001:9a:03.0"),
    (SimpleNamespace(name="a card without PCI fields"), None),
])
def test_the_cards_pci_address_is_named_as_sysfs_names_it(props, bus):
    assert host.bus_id(props) == bus


def _device(tmp_path, name="0000:17:00.0", node="1\n", cpulist="16-31\n"):
    dev = tmp_path / "devices" / name
    dev.mkdir(parents=True)
    (dev / "numa_node").write_text(node)
    (dev / "local_cpulist").write_text(cpulist)
    return tmp_path / "devices"


def test_the_cards_node_and_local_cpus_are_read(tmp_path):
    devices = _device(tmp_path)
    assert host.card_numa("0000:17:00.0", devices) == (1, set(range(16, 32)), None)


@pytest.mark.parametrize("bus, why", [
    (None, "no PCI address"),
    ("0000:18:00.0", "not readable (FileNotFoundError)"),
])
def test_an_unreadable_card_says_why(tmp_path, bus, why):
    node, local, said = host.card_numa(bus, _device(tmp_path))
    assert node is None and local is None and why in said


def test_a_malformed_node_says_why(tmp_path):
    devices = _device(tmp_path, node="none\n")
    assert host.card_numa("0000:17:00.0", devices)[2].endswith("not readable (ValueError)")


def test_the_host_line_names_cpu_affinity_node_and_load(tmp_path):
    proc = tmp_path / "proc"
    proc.mkdir()
    (proc / "cpuinfo").write_text("processor\t: 0\nmodel name\t: Example CPU @ 2.0GHz\n\n"
                                  "processor\t: 1\nmodel name\t: Another CPU\n")
    (proc / "loadavg").write_text("0.50 0.40 0.30 2/300 1234\n")
    line = host.facts("0000:17:00.0", proc=proc, devices=_device(tmp_path),
                      affinity={0, 1, 2, 3, 16})
    assert line == ("host: cpu Example CPU @ 2.0GHz; affinity 0-3,16 (5 CPUs); "
                    "card NUMA node 1, local CPUs 16-31; loadavg 0.50 0.40 0.30 2/300 1234")


def test_a_hidden_model_name_gives_the_family_and_model(tmp_path):
    (tmp_path / "cpuinfo").write_text("processor\t: 0\nvendor_id\t: GenuineIntel\n"
                                      "cpu family\t: 6\nmodel\t\t: 207\n"
                                      "model name\t: unknown\ncpu MHz\t\t: 2590.346\n")
    assert host.cpu_model(tmp_path) == "GenuineIntel family 6 model 207 at 2590.346 MHz"


def test_a_host_that_hides_everything_still_gives_a_line(tmp_path):
    line = host.facts(None, proc=tmp_path / "none", devices=tmp_path / "none", affinity={0})
    assert line == ("host: cpu unknown; affinity 0 (1 CPUs); card NUMA node unknown: "
                    "no PCI address; loadavg not readable")


class _Clock:
    def __init__(self, times):
        self.times = iter(times)

    def __call__(self):
        return next(self.times)


def test_collections_are_counted_by_generation_inside_the_window():
    # (phase, generation) at the clock's successive readings; the window is [10, 20)
    seq = [("start", 0), ("stop", 0),      # 5.0 -> 5.1: before the window
           ("start", 0), ("stop", 0),      # 10.0 -> 10.002
           ("start", 2), ("stop", 2),      # 12.0 -> 12.05
           ("start", 1), ("stop", 1),      # 15.0 -> 15.01
           ("start", 0), ("stop", 0),      # 19.999 -> 20.001: starts inside
           ("start", 2), ("stop", 2)]      # 20.0 -> 20.1: after
    times = [5.0, 5.1, 10.0, 10.002, 12.0, 12.05, 15.0, 15.01, 19.999, 20.001, 20.0, 20.1]
    c = host.Collector(clock=_Clock(times))
    for phase, gen in seq:
        c(phase, {"generation": gen, "collected": 0, "uncollectable": 0})
    got = c.counts((10.0, 20.0))
    assert got[0][0] == 2 and got[0][1] == pytest.approx(0.004)
    assert got[1][0] == 1 and got[1][1] == pytest.approx(0.01)
    assert got[2][0] == 1 and got[2][1] == pytest.approx(0.05)
    assert got["longest_s"] == pytest.approx(0.05)
    assert c.line((10.0, 20.0)) == ("collector in the window: gen0 2 in 0.004000 s, "
                                    "gen1 1 in 0.010000 s, gen2 1 in 0.050000 s; "
                                    "longest 0.050000 s")
    assert c.counts((30.0, 40.0)) == {0: (0, 0.0), 1: (0, 0.0), 2: (0, 0.0), "longest_s": 0.0}


def test_the_collector_is_recorded_only_inside_the_with_block():
    c = host.Collector()
    frozen = gc.get_freeze_count()
    with c:
        assert c in gc.callbacks
        gc.collect()
    assert c not in gc.callbacks
    n = len(c.events)
    gc.collect()
    assert len(c.events) == n
    assert ("start", 2) in [(p, g) for p, g, _ in c.events]
    assert c.counts((float("-inf"), float("inf")))[2][0] >= 1
    assert gc.isenabled() and gc.get_freeze_count() == frozen    # counted, not changed
