"""The piece of the control plane the port's router needs: flow control
(`cluster.flowcontrol`)."""
