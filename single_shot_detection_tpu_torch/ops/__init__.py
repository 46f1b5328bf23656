"""Detection math on tensors: boxes, coding, anchors (numpy), NMS and the
postprocessor."""
