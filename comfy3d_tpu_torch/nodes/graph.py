"""The ComfyUI workflow-JSON executor.

Port of `comfy3d_tpu/nodes/graph.py`: it runs the editor's JSON format
(`nodes` with `widgets_values` and `inputs` link references, `links` rows
[id, from_node, from_slot, to_node, to_slot, type]) headlessly, node by
node in dependency order, with the JAX executor's widget consumption:
a widget converted to an input keeps its placeholder in `widgets_values`
and is popped; a `seed` / `noise_seed` widget's trailing
`control_after_generate` string is popped too; optional widgets are
skipped once the values run out; muted nodes (`mode` 2) are dropped; a
dict result is unwrapped to its "result".

Every node runs on `resolve_device(device)` (the card unless the caller
asks for the CPU), which the nodes read through `base.node_device()`. The
run is a `torch.profiler.record_function` span "workflow", each node one
"node#<id> <type>": free when no profiler runs.
"""

from __future__ import annotations

import json
from typing import Any, Dict, Optional

from torch.profiler import record_function

from .base import NODE_CLASS_MAPPINGS, run_device

WORKFLOW_SPAN = "workflow"


class WorkflowError(RuntimeError):
    pass


def node_span(nid, type_name: str) -> str:
    """A node's profiler span name."""
    return f"node#{nid} {type_name}"


def _widget_input_names(cls) -> list:
    """(name, whether it is a widget) of each INPUT_TYPES entry, required
    then optional, in declaration order; the other entries are link-typed
    and come from graph edges."""
    names = []
    for section in ("required", "optional"):
        for name, decl in cls.INPUT_TYPES().get(section, {}).items():
            t = decl[0] if isinstance(decl, (tuple, list)) else decl
            names.append((name, isinstance(t, list) or t in (
                "STRING", "INT", "FLOAT", "BOOLEAN")))
    return names


def run_workflow(workflow: Dict | str, overrides: Optional[Dict] = None,
                 verbose: bool = False, device=None) -> Dict[int, Any]:
    """Execute a workflow (a dict, or a JSON file's path) on
    `resolve_device(device)`; returns {node_id: outputs tuple}.

    overrides: {node_id: {input_name: value}}, values that replace the
    widgets' (e.g. smaller sizes) without editing the JSON."""
    if isinstance(workflow, str):
        with open(workflow) as fh:
            workflow = json.load(fh)
    with run_device(device), record_function(WORKFLOW_SPAN):
        return _run_workflow(workflow, overrides or {}, verbose)


def _order(nodes: Dict, links: Dict) -> list:
    deps: Dict[int, set] = {nid: set() for nid in nodes}
    for n in nodes.values():
        for inp in n.get("inputs", []) or []:
            if inp.get("link") is not None and inp["link"] in links:
                deps[n["id"]].add(links[inp["link"]][0])
    order, seen = [], set()

    def visit(nid, stack=()):
        if nid in seen:
            return
        if nid in stack:
            raise WorkflowError(f"cycle at node {nid}")
        for d in deps.get(nid, ()):
            if d in nodes:
                visit(d, stack + (nid,))
        seen.add(nid)
        order.append(nid)

    for nid in nodes:
        visit(nid)
    return order


def _kwargs(cls, widgets: list, link_inputs: Dict) -> Dict:
    """The call's arguments: linked inputs, then widgets in order."""
    kwargs = {}
    for name, is_widget in _widget_input_names(cls):
        if name in link_inputs:
            # a widget converted to an input keeps its placeholder in
            # widgets_values: pop it, or later widgets shift one slot
            if is_widget and widgets:
                widgets.pop(0)
                if name in ("seed", "noise_seed") and widgets and \
                        isinstance(widgets[0], str):
                    widgets.pop(0)
            kwargs[name] = link_inputs[name]
            continue
        if is_widget and widgets:
            val = widgets.pop(0)
            # ComfyUI stores control_after_generate after seed widgets
            if name in ("seed", "noise_seed") and widgets and \
                    isinstance(widgets[0], str):
                widgets.pop(0)
            kwargs[name] = val
    return kwargs


def _run_workflow(workflow: Dict, overrides: Dict,
                  verbose: bool) -> Dict[int, Any]:
    nodes = {n["id"]: n for n in workflow["nodes"]
             if n.get("mode", 0) != 2}          # mode 2 = muted
    links = {}
    for row in workflow.get("links", []):
        link_id, src, src_slot, _dst, _dst_slot, _type = row[:6]
        links[link_id] = (src, src_slot)

    results: Dict[int, Any] = {}
    for nid in _order(nodes, links):
        n = nodes[nid]
        type_name = n["type"]
        cls = NODE_CLASS_MAPPINGS.get(type_name)
        if cls is None:
            raise WorkflowError(f"unknown node type {type_name!r} "
                                f"(node {nid})")
        link_inputs = {}
        for inp in n.get("inputs", []) or []:
            if inp.get("link") is not None and inp["link"] in links:
                src, slot = links[inp["link"]]
                if src not in results:
                    raise WorkflowError(
                        f"node {nid} depends on unexecuted node {src}")
                link_inputs[inp["name"]] = results[src][slot]
        kwargs = _kwargs(cls, list(n.get("widgets_values") or []),
                         link_inputs)
        kwargs.update(overrides.get(nid, {}))
        if verbose:
            print(f"[graph] #{nid} {type_name}")
        with record_function(node_span(nid, type_name)):
            out = getattr(cls(), cls.FUNCTION)(**kwargs)
        if isinstance(out, dict):          # OUTPUT_NODE ui convention
            out = out.get("result", ())
        results[nid] = out
    return results


def load_node_mappings():
    """Import every node module (each registers its classes)."""
    from . import (nodes_crm, nodes_diffusers, nodes_hunyuan3d,  # noqa: F401
                   nodes_io, nodes_models, nodes_mvdiffusion,
                   nodes_partcrafter, nodes_preprocess, nodes_render,
                   nodes_texture, nodes_vendor)
    return NODE_CLASS_MAPPINGS
